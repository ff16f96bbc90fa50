"""Hand-written CUDA kernels for Hopper, one package per kernel.

Each kernel package has:
  csrc/*.cu — the CUDA C++ source, built for sm_90a by ``_build``
  kernel.py — the wrapper: checks, allocation, launch, launch counter
  ops.py    — the entry point: the kernel for CUDA tensors, ``ref`` for CPU
  ref.py    — the plain PyTorch version the kernel is held to
"""
