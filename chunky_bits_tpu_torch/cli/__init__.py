"""Coreutils-style CLI (the reference's src/bin/chunky-bits/), on the port:
``python -m chunky_bits_tpu_torch.cli`` or ``python -m chunky_bits_tpu_torch``."""

from chunky_bits_tpu_torch.cli.cluster_location import (  # noqa: F401
    ClusterLocation,
)
from chunky_bits_tpu_torch.cli.config import Config  # noqa: F401
