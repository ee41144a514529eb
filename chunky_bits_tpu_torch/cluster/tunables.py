"""Environment accessors: the one home for ``CHUNKY_BITS_TORCH_*`` reads.

A stand-alone copy of ``env_str`` from ``chunky_bits_tpu/cluster/tunables.py``;
its ``env_flag`` and ``env_seconds`` come over with the first knob that needs
them.  The port reads only its own prefix, so a process that configures the
JAX package through ``CHUNKY_BITS_TPU_*`` leaves the port as it is.  Callers
read a knob at the moment it takes effect, never at import time.
"""

from __future__ import annotations

import os

#: prefix of every environment variable the port reads
ENV_PREFIX = "CHUNKY_BITS_TORCH_"

#: default erasure backend name (``numpy``, ``torch`` or ``cuda``)
BACKEND_ENV = ENV_PREFIX + "BACKEND"

#: "1" hashes shards on the card inside the encode dispatch
DEVICE_SHA_ENV = ENV_PREFIX + "DEVICE_SHA"


def env_str(name: str, default: str = "") -> str:
    """Raw string value of an env knob; unset reads as ``default``."""
    return os.environ.get(name, default)
