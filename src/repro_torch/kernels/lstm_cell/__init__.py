"""Fused LSTM kernels: ``kernel.py`` (the CUDA wrappers: the one-step cell,
the serving forward, the training forward, the backward), ``ops.py`` (the
dispatching entry points, the fused sequence's ``autograd.Function`` and the
per-step scan) and ``ref.py`` (the plain PyTorch versions)."""
