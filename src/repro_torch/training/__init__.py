"""Training for the port: the optimizer, checkpoints and the
fault-tolerant loop behind ``Accelerator.train_qat`` (the LM-side
``step``/``compress`` modules are not ported yet)."""

from repro_torch.training.optimizer import OptConfig, init_opt_state, apply_updates  # noqa: F401
