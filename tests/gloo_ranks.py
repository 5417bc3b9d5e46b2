"""Run a script on several gloo ranks, one subprocess each, for the
port's multi-rank tests (``tests/test_torch_distributed*.py``)."""

import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# Every rank: a gloo group over the FileStore, one thread (the ranks
# share the CPU), then the script; its last stdout line is its JSON.
PRELUDE = """
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
WORLD = int(os.environ["GLOO_WORLD"])
dist.init_process_group("gloo", rank=int(os.environ["GLOO_RANK"]),
                        world_size=WORLD,
                        store=dist.FileStore(os.environ["GLOO_STORE"], WORLD))
RANK = dist.get_rank()
"""


def run_ranks(script: str, world: int, store: str, timeout: float = 300):
    """``script`` on ``world`` gloo ranks; every rank's JSON result."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_WORLD=str(world), GLOO_STORE=store)
    code = PRELUDE + textwrap.dedent(script) + "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env=dict(env, GLOO_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
