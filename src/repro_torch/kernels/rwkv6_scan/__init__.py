"""The RWKV6 WKV scan: ``kernel.py`` (the CUDA wrapper), ``ops.py`` (``wkv``,
the entry point) and ``ref.py`` (the plain PyTorch versions)."""
