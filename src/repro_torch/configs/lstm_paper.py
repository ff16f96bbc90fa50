"""The paper's own forecaster (Sec. 6.1.2, Fig. 6).

LSTM(40) -> Dense(10, ReLU) -> Dense(1) with 5 input features and lag n=5.
This is the batch/speed model of the faithful reproduction.
"""
from repro_torch.configs.base import LSTMConfig, ModelConfig

CONFIG = ModelConfig(
    name="lstm-paper",
    family="lstm",
    # the reference's transformer-shaped fields, which its analytic
    # parameter and FLOP counts read
    n_layers=1,
    d_model=40,
    n_heads=1,
    n_kv_heads=1,
    d_ff=10,
    vocab_size=0,
    attention="none",
    dtype="float32",
    param_dtype="float32",
    lstm=LSTMConfig(hidden=40, dense=10, n_features=5, lag=5, out_dim=1),
    citation="Wang et al. 2022, FGCS (this paper), Fig. 6",
)
