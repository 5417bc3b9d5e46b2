"""``forward_train`` against the JAX package in its other variants: the
w8a8 fake-quant (every linear and the MoE experts through the
straight-through estimator), the hard activations (C2) and bf16
activations over f32 master weights, on the reference's weights carried
across and the same numpy inputs (helpers in
``tests/test_torch_lm_train.py``).

Tolerances:
  * w8a8 and hard activations, in f32: as the f32 case, the loss to 1e-5
    relative and each gradient leaf to 1e-4 of its largest reference
    value.
  * bf16: the two frameworks round bf16 at other places (inside the
    activations and the matmul accumulators), and the differences grow
    through the layers: the loss to ``BF16_LOSS_RTOL`` = 2^-8, one bf16
    rounding of the logits it is computed from (measured up to 2.1e-3),
    each gradient leaf to ``BF16_GRAD_TOL`` = 0.1 of its largest
    reference value (measured up to 0.03).
"""

import pytest

from repro_torch.configs import ASSIGNED_ARCHS

from test_torch_lm_train import F32_GRAD_TOL, F32_LOSS_RTOL, check_train_parity, ref  # noqa: F401

BF16_LOSS_RTOL, BF16_GRAD_TOL = 2.0 ** -8, 0.1


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b", "rwkv6-7b"])
def test_forward_train_w8a8_fake_quant_matches_jax(arch):
    check_train_parity(arch, F32_LOSS_RTOL, F32_GRAD_TOL, quant="w8a8")


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b"])
def test_forward_train_hard_acts_matches_jax(arch):
    check_train_parity(arch, F32_LOSS_RTOL, F32_GRAD_TOL, hard_acts=True)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_forward_train_loss_and_gradients_match_jax_bf16(arch):
    check_train_parity(arch, BF16_LOSS_RTOL, BF16_GRAD_TOL, dtype="bfloat16")
