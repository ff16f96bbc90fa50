"""Models of the port: the paper's LSTM forecaster, the dense transformer,
RWKV6 and the Zamba2 hybrid."""
