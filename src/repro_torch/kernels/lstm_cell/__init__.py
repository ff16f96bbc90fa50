"""Fused LSTM sequence kernels: ``kernel.py`` (the CUDA wrappers: serving
forward, training forward, backward), ``ops.py`` (the dispatching entry point
and its ``autograd.Function``) and ``ref.py`` (the plain PyTorch versions)."""
