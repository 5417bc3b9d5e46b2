"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The paper's integer LSTM datapath, as the session API and the serving
tier drive it: ``build(QLSTMConfig, AcceleratorConfig)`` ->
``quantize()`` -> ``infer(path="int")`` / ``infer_int`` ->
``serving.StreamServer`` (or ``build_cluster``'s replicas behind a
consistent-hash ``serving.ClusterServer``), with the fused steps on
hand-written CUDA kernels (``kernels/qlstm_cell.py``,
``csrc/qlstm_cell.cu``).  The JAX
package ``repro`` is the reference; this package imports neither it nor
JAX.  ``repro_torch.serving`` loads on first use.
"""

from repro_torch.api import Accelerator, build, build_cluster  # noqa: F401
from repro_torch.core.accelerator import AcceleratorConfig  # noqa: F401
from repro_torch.core.qlstm import QLSTMConfig  # noqa: F401

__all__ = ["Accelerator", "AcceleratorConfig", "QLSTMConfig", "build",
           "build_cluster"]
