"""Launchers of the port: ``edge_cloud``, the paper's deployments on the
bus."""
