"""Training for the port: the optimizer, checkpoints, the fault-tolerant
loop behind ``Accelerator.train_qat``, and the LM train step with
gradient compression — counterpart of ``repro/training``."""

from repro_torch.training.optimizer import OptConfig, init_opt_state, apply_updates  # noqa: F401
from repro_torch.training.step import TrainPlan, init_train_state, make_train_step  # noqa: F401
