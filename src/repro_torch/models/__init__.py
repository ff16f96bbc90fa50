"""Models of the port: the paper's LSTM forecaster and the dense
transformer."""
