"""Host-plane parallelism: the shared host compute pipeline."""
