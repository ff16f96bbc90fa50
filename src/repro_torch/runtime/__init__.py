"""Executors of the port: the synchronous in-process loop."""
