"""The paper's own model: 1 LSTM cell (hidden 20) + dense, PeMS-4W
single-step-ahead traffic prediction, (4,8) fixed point, HardSigmoid*/
HardTanh — §6.1 experimental settings.  Counterpart of
``repro/configs/lstm_pems.py``, built on the port's ``QLSTMConfig``."""
from repro_torch.core.qlstm import ActivationConfig, QLSTMConfig

CONFIG = QLSTMConfig(input_size=1, hidden_size=20, num_layers=1,
                     out_features=1, seq_len=6, acts=ActivationConfig())
