"""Int8 dequantizing matmul: ``kernel.py`` (the CUDA wrapper), ``ops.py``
(``qmatmul``, the ``QTensor`` entry point) and ``ref.py`` (the plain
PyTorch version)."""
