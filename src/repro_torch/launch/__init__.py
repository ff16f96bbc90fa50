"""Launchers of the port: ``edge_cloud``, the paper's deployments on the
bus, and ``serve``, the serving engine on a reduced arch."""
