"""The Mamba2 selective scan: ``kernel.py`` (the CUDA wrapper), ``ops.py``
(``selective_scan``, the entry point) and ``ref.py`` (the plain PyTorch
versions)."""
