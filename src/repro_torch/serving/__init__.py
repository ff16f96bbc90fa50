"""Serving of the port: int8 weight quantization for the edge's model sync."""
