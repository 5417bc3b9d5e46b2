"""The port stands alone: no module of ``repro_torch``, no script of
``examples/torch`` and no line of ``chip_smoke.py`` imports JAX or the
JAX package ``repro``, and the package imports in a process where both
are blocked."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_neither_jax_nor_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.api, repro_torch.serving\n"
            "import repro_torch.convert, repro_torch.kernels.qlstm_cell\n"
            "import repro_torch.kernels.quant_matmul\n"
            "import repro_torch.kernels.hard_act\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.serving.cluster, repro_torch.serving.faults\n"
            "import repro_torch.serving.routing, repro_torch.cells.gru\n"
            "import repro_torch.cells.rglru, repro_torch.launch.mesh\n"
            "import repro_torch.sharding.partition\n"
            "import repro_torch.explore, repro_torch.core.energy\n"
            "import repro_torch.analysis.report, repro_torch.analysis.hlo\n"
            "import repro_torch.launch.dryrun\n"
            "from repro_torch import explore\n"
            "pl = explore.sweep(explore.SearchSpace(batch=4, hidden_size=8),\n"
            "                   iters=1, device='cpu')\n"
            "print(pl['points'][0]['status'], pl['front'] == [pl['points'][0]['label']])\n"
            "import torch\n"
            "from repro_torch.core.fixed_point import FXP_4_8\n"
            "from repro_torch.kernels import ops\n"
            "s = repro_torch.build(device='cpu').quantize()\n"
            "print(tuple(s.infer([[[0.5]] * 6], path='int').shape))\n"
            "g = repro_torch.build(repro_torch.QLSTMConfig(cell='gru'),\n"
            "                      device='cpu').quantize()\n"
            "c = repro_torch.build_cluster(g, 2)\n"
            "print(c.replica_for('s0'))\n"
            "c.close(timeout=30)\n"
            "x = torch.ones(3, 4, dtype=torch.int8)\n"
            "y = ops.quant_matmul_requant(x, x.T.contiguous(), FXP_4_8)\n"
            "print(ops.hard_sigmoid_star_int(y, FXP_4_8, 'step').tolist())\n"
            "import repro_torch.models.transformer as T\n"
            "import repro_torch.launch.serve, repro_torch.kernels.rglru_scan\n"
            "from repro_torch.configs import ARCH_CONFIGS, reduce_config\n"
            "cfg = reduce_config(ARCH_CONFIGS['recurrentgemma-2b'])\n"
            "p, _ = T.init_model(cfg, torch.Generator().manual_seed(0))\n"
            "lg = T.forward_prefill(p, {'tokens': torch.ones(2, 12, dtype=torch.long)}, cfg)\n"
            "print(tuple(lg.shape), bool(torch.isfinite(lg).all()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "ok True", "(1, 1)", "r1", "[[8, 8, 8], [8, 8, 8], [8, 8, 8]]",
        "(2, 1, 128) True"]
