"""Models of the port: the paper's LSTM forecaster, the dense transformer
and RWKV6."""
