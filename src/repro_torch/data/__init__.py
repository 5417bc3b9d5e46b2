"""Training data for the port — counterpart of ``repro/data``: the
synthetic PeMS-like traffic series (QLSTM), the synthetic LM token stream
and the prefetching, step-keyed pipeline."""

from repro_torch.data.timeseries import pems_like_dataset  # noqa: F401
from repro_torch.data.lm_data import SyntheticLM  # noqa: F401
from repro_torch.data.pipeline import Pipeline  # noqa: F401
