"""Flash attention: ``kernel.py`` (the CUDA wrapper), ``ops.py`` (``gqa_flash``
and ``flash_attend``, the entry points) and ``ref.py`` (the plain PyTorch
versions)."""
