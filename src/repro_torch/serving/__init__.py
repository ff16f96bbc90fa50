"""Serving of the port: int8 weight quantization for the edge's model sync
(``quantize``), request batching (``batching``) and the model zoo's serving
engine (``engine``)."""
