"""Cluster plane of the port; only the env accessors are ported so far."""
