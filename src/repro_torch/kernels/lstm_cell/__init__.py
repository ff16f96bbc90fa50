"""Fused LSTM sequence kernel: ``kernel.py`` (the CUDA wrapper), ``ops.py``
(the dispatching entry point) and ``ref.py`` (the plain PyTorch version)."""
