"""Environment accessors: the one home for ``CHUNKY_BITS_TORCH_*`` reads.

Stand-alone copies of ``env_str``, ``env_flag``, ``host_threads`` and
``dispatch_depth`` from ``chunky_bits_tpu/cluster/tunables.py``, plus
``virtual_devices`` (the port's stand-in for the JAX package's forced host
device count); ``env_seconds`` comes over with the first knob that needs
it.  The port reads only its own prefix, so a process
that configures the JAX package through ``CHUNKY_BITS_TPU_*`` leaves the port
as it is.  Callers read a knob at the moment it takes effect, never at import
time.
"""

from __future__ import annotations

import os

#: prefix of every environment variable the port reads
ENV_PREFIX = "CHUNKY_BITS_TORCH_"

#: default erasure backend name (``numpy``, ``torch`` or ``cuda``)
BACKEND_ENV = ENV_PREFIX + "BACKEND"

#: "1" hashes shards on the card inside the encode dispatch
DEVICE_SHA_ENV = ENV_PREFIX + "DEVICE_SHA"

#: flag: the field-multiplexed GF(2^8) kernel at the geometries it takes
#: (``gf_kernel.packed_geometry_ok``); off by default, as in the JAX package
PACKED_KERNEL_ENV = ENV_PREFIX + "PACKED_KERNEL"

#: host compute worker count of the shared host pipeline (0/unset = one
#: per core)
HOST_THREADS_ENV = ENV_PREFIX + "HOST_THREADS"

#: flag: keep every local read and ingest source off mmap (sources that
#: another process may truncate while they are read)
NO_MMAP_ENV = ENV_PREFIX + "NO_MMAP"

#: in-flight sharded dispatches of the mesh backends' window (0 = every
#: dispatch completes before the next is issued)
DISPATCH_DEPTH_ENV = ENV_PREFIX + "DISPATCH_DEPTH"

#: n > 0: the mesh backends see n logical devices on ``cuda:0`` (one
#: stream each) instead of one per CUDA device; the counterpart of the
#: JAX package's forced host device count (``utils/virtualmesh.py``)
VIRTUAL_DEVICES_ENV = ENV_PREFIX + "VIRTUAL_DEVICES"

_FALSY = ("", "0", "false", "no", "off")


def env_str(name: str, default: str = "") -> str:
    """Raw string value of an env knob; unset reads as ``default``."""
    return os.environ.get(name, default)


def env_flag(name: str, *, default: bool = False) -> bool:
    """Boolean env flag: unset -> ``default``; "", "0", "false", "no",
    "off" (any case, surrounding whitespace ignored) -> False; anything
    else -> True."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSY


def host_threads(*, default: int = 0) -> int:
    """Requested host worker count from ``$CHUNKY_BITS_TORCH_HOST_THREADS``;
    unset, malformed or non-positive reads as ``default`` (0 = one worker
    per core).  The shared pipeline clamps to ``min(N, nproc)``."""
    raw = os.environ.get(HOST_THREADS_ENV, "")
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def dispatch_depth(*, default: int = 2) -> int:
    """Requested dispatch-window depth from
    ``$CHUNKY_BITS_TORCH_DISPATCH_DEPTH``; unset, malformed or negative
    reads as ``default``.  Lenient like ``host_threads``; 0 is a valid
    value (overlap off, fully serial dispatch)."""
    raw = os.environ.get(DISPATCH_DEPTH_ENV, "")
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v >= 0 else default


def virtual_devices() -> int:
    """Logical devices to carve out of ``cuda:0`` from
    ``$CHUNKY_BITS_TORCH_VIRTUAL_DEVICES``; unset, malformed or
    non-positive reads as 0 (one logical device per CUDA device)."""
    raw = os.environ.get(VIRTUAL_DEVICES_ENV, "")
    try:
        v = int(raw)
    except ValueError:
        return 0
    return max(v, 0)
