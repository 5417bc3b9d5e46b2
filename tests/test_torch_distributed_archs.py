"""One train step of every other LM arch on a (2 data x 2 model) mesh of
gloo ranks, against the port's own one-device step on the same params
and batch (``tests/test_torch_lm_train.py`` holds that step against the
reference).  One 4-rank run, read by a module-scoped fixture, covers all
of them; phi3.5-moe runs under its expert-parallel override.  Tolerances
are the reference's distributed ones: 2e-3 relative on the loss, 5e-2
on the gradient norm; every rank reports the same values.
"""

import pytest

from gloo_ranks import run_ranks

ARCHS = ("gemma2-2b", "gemma2-27b", "mixtral-8x7b", "phi3.5-moe",
         "codeqwen1.5-7b", "qwen2-vl-2b", "musicgen-medium", "rwkv6-7b")
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-2

RUN = """
import numpy as np
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import batch_shardings
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P
from repro_torch.training import step as TS
from repro_torch.training.optimizer import OptConfig

B, S = 4, 16          # rwkv6: two of its 8-token wkv chunks
mesh = make_host_mesh(model_parallel=2, device_type="cpu")
out = {}
for arch in %(archs)r:
    cfg = reduce_config(ARCH_CONFIGS[arch])
    params, axes = T.init_model(cfg, torch.Generator().manual_seed(0))
    b = SyntheticLM(cfg.vocab_size, seed=5).batch(0, B, S)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    if cfg.attn and cfg.attn.mrope_sections:
        pos = torch.arange(S)
        batch["position_ids"] = torch.stack([pos, pos // 2, pos %% 3])[:, None].expand(3, B, S)
    if not cfg.embed_inputs:
        rng = np.random.default_rng(5)
        batch["inputs_embeds"] = torch.as_tensor(
            rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)).bfloat16()
        del batch["tokens"]
    plan = TS.TrainPlan(opt=OptConfig(lr=1e-3))
    step = TS.make_train_step(cfg, plan)
    _, m1 = step(TS.init_train_state(params, plan), batch)
    with P.rules_context(mesh, cfg.sharding_overrides):
        shard = P.param_shardings(axes, mesh, cfg.sharding_overrides, params)
        state = TS.init_train_state(P.distribute(params, shard), plan)
        sbatch = P.distribute(batch, batch_shardings(batch, mesh,
                                                     cfg.sharding_overrides))
        _, m2 = step(state, sbatch)
    mlp = shard["blocks"]["mlp"]
    out[arch] = {"one": {k: float(m1[k]) for k in ("loss", "grad_norm")},
                 "mesh": {k: float(m2[k]) for k in ("loss", "grad_norm")},
                 "w_up": list((mlp["w_up"] if "w_up" in mlp else mlp["cm_k"]).spec)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("archs")
    return run_ranks(RUN % {"archs": ARCHS}, 4, str(d / "store"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_a_2x2_mesh_matches_one_device(ranks, arch):
    got, want = ranks[0][arch]["mesh"], ranks[0][arch]["one"]
    for k, rtol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
        assert abs(got[k] - want[k]) / max(abs(want[k]), 1e-9) < rtol, (k, got, want)
    assert all(r[arch]["mesh"] == got for r in ranks)
    if arch == "phi3.5-moe":      # expert parallel: experts over "model"
        assert ranks[0][arch]["w_up"] == [None, "model", "data", None]
    elif arch == "mixtral-8x7b":  # TP-MoE: each expert's ff dim over "model"
        assert ranks[0][arch]["w_up"] == [None, None, "data", "model"]
