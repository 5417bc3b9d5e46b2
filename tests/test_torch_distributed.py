"""The sharded LM on real multi-rank meshes: gloo ranks on the CPU, one
subprocess each (a ``FileStore`` under ``tmp_path``), like the
reference's ``tests/test_distributed.py``.

One 8-rank run holds reduced qwen1.5-0.5B and reduced RecurrentGemma on a
(2 data x 4 model) mesh with two microbatches against the reference's
one-device JAX step on the same params (carried across with
``convert.lm_params_from_reference``) and the port's own one-device step,
and saves qwen's params from a (4 x 2) mesh; a 2-rank run restores them
onto (2 x 1).  Tolerances are the reference's: 2e-3 relative on the
loss and 5e-2 on the gradient norm (bf16 activations, so another
reduction order moves the loss by a few bf16 ulps); every rank reports
the same loss; the elastic restore is bit for bit and its sum within
1e-3 of the saved one's.
"""

import pickle

import numpy as np
import pytest
import torch

from gloo_ranks import run_ranks
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.training import step as TS
from repro_torch.training.optimizer import OptConfig

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.models import transformer as JT
    from repro.training import step as JS
    from repro.training.optimizer import OptConfig as JOptConfig
except ImportError:
    jax = None

LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-2
ARCHS = ("qwen1.5-0.5b", "recurrentgemma-2b")

def _batch(cfg):
    return SyntheticLM(cfg.vocab_size, seed=3).batch(0, 8, 16)


def _plan():
    return TS.TrainPlan(opt=OptConfig(lr=1e-3), microbatches=2)


def _one_device(arch, params_np, batch):
    """The port's step on one device (plain tensors)."""
    cfg = reduce_config(ARCH_CONFIGS[arch])
    params = lm_params_from_reference(params_np)
    _, m = TS.make_train_step(cfg, _plan())(
        TS.init_train_state(params, _plan()),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


MESH_RUN = """
import pickle
import numpy as np
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.kernels import rglru_scan as K
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import batch_shardings
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import step as TS
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.tree import tree_leaves

d = sys.argv[1]
scans = []
plain = K.rglru_seq_plain
def counted(log_a, b, **kw):       # K7's plain version, as the CPU runs it
    scans.append(tuple(b.shape))
    return plain(log_a, b, **kw)
K.rglru_seq_plain = counted

out = {}
mesh = make_host_mesh(model_parallel=4, device_type="cpu")       # 2 x 4
for arch in %(archs)r:
    cfg = reduce_config(ARCH_CONFIGS[arch])
    with open(os.path.join(d, arch + ".pkl"), "rb") as f:
        params = lm_params_from_reference(pickle.load(f))
    _, axes = T.init_model(cfg, None)
    plan = TS.TrainPlan(opt=OptConfig(lr=1e-3), microbatches=2)
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLM(cfg.vocab_size, seed=3).batch(0, 8, 16).items()}
    scans.clear()
    with P.rules_context(mesh, cfg.sharding_overrides):
        shard = P.param_shardings(axes, mesh, cfg.sharding_overrides, params)
        state = TS.init_train_state(P.distribute(params, shard), plan)
        sbatch = P.distribute(batch, batch_shardings(batch, mesh))
        new, m = TS.make_train_step(cfg, plan)(state, sbatch)
        placed = all(tuple(n.placements) == tuple(s.placements)
                     for n, s in zip(tree_leaves(new["params"]),
                                     tree_leaves(state["params"])))
        out[arch] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "params_placed": placed, "scans": sorted(set(scans)),
                     "n_scans": len(scans),
                     "embed": [[type(p).__name__, getattr(p, "dim", None)]
                               for p in new["params"]["embed"].placements]}

# the elastic checkpoint: qwen's params saved from a 4 x 2 mesh
cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
with open(os.path.join(d, "qwen1.5-0.5b.pkl"), "rb") as f:
    params = lm_params_from_reference(pickle.load(f))
_, axes = T.init_model(cfg, None)
mesh42 = make_host_mesh(model_parallel=2, device_type="cpu")
sp = P.distribute(params, P.param_shardings(axes, mesh42, (), params))
ckpt.save(os.path.join(d, "ck"), sp, 3)
out["saved_sum"] = float(sum(x.float().sum() for x in tree_leaves(params)))
out["mesh42"] = list(mesh42.shape)
print(json.dumps(out))
"""

RESTORE_RUN = """
import pickle
from torch.distributed.tensor import DTensor
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.tree import tree_leaves

d = sys.argv[1]
cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
like, axes = T.init_model(cfg, torch.Generator().manual_seed(99))  # another init
mesh = make_host_mesh(model_parallel=1, device_type="cpu")          # 2 x 1: elastic
restored = ckpt.restore(os.path.join(d, "ck"), like,
                        shardings=P.param_shardings(axes, mesh, (), like))
with open(os.path.join(d, "qwen1.5-0.5b.pkl"), "rb") as f:
    saved = lm_params_from_reference(pickle.load(f))
leaves = tree_leaves(restored)
print(json.dumps({
    "resharded": all(isinstance(x, DTensor) and x.device_mesh.size() == 2
                     for x in leaves),
    "bit_for_bit": all(torch.equal(x.full_tensor(), y)
                       for x, y in zip(leaves, tree_leaves(saved))),
    "sum": float(sum(x.full_tensor().float().sum() for x in leaves)),
    "mesh": list(mesh.shape)}))
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's and the port's one-device steps, the 8-rank mesh run
    and the 2-rank elastic restore."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    d = tmp_path_factory.mktemp("mesh")
    ref, one = {}, {}
    for arch in ARCHS:
        j_cfg = j_reduce(J_ARCHS[arch])
        params, _ = JT.init_model(j_cfg, jax.random.key(0))
        params_np = jax.tree.map(np.asarray, params)
        with open(d / f"{arch}.pkl", "wb") as f:
            pickle.dump(params_np, f)
        plan = JS.TrainPlan(opt=JOptConfig(lr=1e-3), microbatches=2)
        _, m = jax.jit(JS.make_train_step(j_cfg, plan))(
            JS.init_train_state(params, plan),
            {k: jnp.asarray(v) for k, v in _batch(j_cfg).items()})
        ref[arch] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        one[arch] = _one_device(arch, params_np, _batch(j_cfg))
    script = MESH_RUN % {"archs": ARCHS}
    ranks = run_ranks(f"sys.argv = ['', {str(d)!r}]\n" + script, 8,
                      str(d / "store8"))
    restored = run_ranks(f"sys.argv = ['', {str(d)!r}]\n" + RESTORE_RUN, 2,
                         str(d / "store2"))
    return {"ref": ref, "one": one, "ranks": ranks, "restored": restored}


def _close(got, want):
    for k, rtol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
        rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-9)
        assert rel < rtol, (k, got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_tp_train_step_matches_the_reference_single_device(mesh_runs, arch):
    """The (2 data x 4 model) step with two microbatches against the
    reference's one-device JAX step and the port's own; every rank
    reports the same loss, and the new params keep their placements."""
    got = mesh_runs["ranks"][0][arch]
    _close(got, mesh_runs["ref"][arch])
    _close(got, mesh_runs["one"][arch])
    assert all(r[arch]["loss"] == got["loss"] for r in mesh_runs["ranks"])
    assert all(r[arch]["grad_norm"] == got["grad_norm"] for r in mesh_runs["ranks"])
    assert got["params_placed"]
    # the embedding (vocab, embed): vocab over "model", embed over "data"
    assert got["embed"] == [["Shard", 1], ["Shard", 0]]


def test_rglru_scan_runs_on_local_shards(mesh_runs):
    """K7 (its plain version on the CPU) runs through ``local_map`` on each
    rank's own rows and width: 8 rows / 2 data ranks / 2 microbatches, 64
    channels / 4 model ranks, the whole 16 steps; forward and backward."""
    got = mesh_runs["ranks"][0]["recurrentgemma-2b"]
    assert got["scans"] == [[16, 2, 16]]
    cfg = reduce_config(ARCH_CONFIGS["recurrentgemma-2b"])
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    assert got["n_scans"] == 2 * n_rec * 2       # (forward + backward) x 2 micro
    assert mesh_runs["ranks"][0]["qwen1.5-0.5b"]["n_scans"] == 0


def test_elastic_checkpoint_resharding(mesh_runs):
    """Saved from a 4 x 2 mesh, restored onto 2 x 1 (another rank count)
    into a differently initialised tree: every leaf bit for bit."""
    saved = mesh_runs["ranks"][0]
    assert saved["mesh42"] == [4, 2]
    for r in mesh_runs["restored"]:
        assert r["mesh"] == [2, 1]
        assert r["resharded"] and r["bit_for_bit"]
        assert abs(r["sum"] - saved["saved_sum"]) < 1e-3
