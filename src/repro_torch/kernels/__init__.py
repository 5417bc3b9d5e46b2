"""Hand-written Hopper kernels and their plain torch versions
(counterpart of ``repro/kernels``), each CUDA C++ in ``csrc/`` built by
``_build`` at first use:

  * ``qlstm_cell``      — the fused quantised LSTM stack and its slot
    variant (``csrc/qlstm_cell.cu``);
  * ``quant_matmul``    — integer GEMM, int32 accumulator, fused S5
    requantisation (``csrc/quant_matmul.cu``);
  * ``hard_act``        — HardSigmoid* (arithmetic | step | 1to1) and
    HardTanh on codes (``csrc/hard_act.cu``);
  * ``flash_attention`` — fp32 online-softmax attention
    (``csrc/flash_attention.cu``);
  * ``ops``             — the public wrappers, with the reference's names;
  * ``ref``             — the plain-torch oracles.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
