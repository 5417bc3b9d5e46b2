"""Hand-written Hopper kernels and their plain torch versions
(counterpart of ``repro/kernels``): ``qlstm_cell`` (the fused quantised
LSTM stack and its slot variant, CUDA C++ in ``csrc/qlstm_cell.cu``,
built by ``_build``) and ``ref`` (the plain-torch oracle)."""
