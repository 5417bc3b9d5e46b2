"""Training data for the port: the synthetic PeMS-like traffic series.

Counterpart of ``repro/data`` for the QLSTM's training path; the
LM-side sources (``lm_data``, ``pipeline``) are not ported yet."""

from repro_torch.data.timeseries import pems_like_dataset  # noqa: F401
