"""Observability plane: the metrics registry and request tracing (stdlib
only, so every layer may feed them without import cycles)."""

from chunky_bits_tpu_torch.obs import metrics, tracing  # noqa: F401
