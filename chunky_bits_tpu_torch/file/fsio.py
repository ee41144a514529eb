"""The storage plane's filesystem seam (canonical surface): the port of
``chunky_bits_tpu/file/fsio.py``.  The implementation lives in
``utils/fsio.py`` and is re-exported here whole; both names share the one
active provider.
"""

from __future__ import annotations

from chunky_bits_tpu_torch.utils.fsio import (  # noqa: F401
    FaultyFsProvider,
    FsOp,
    FsProvider,
    RecordingFsProvider,
    active,
    fsync,
    fsync_dir,
    install,
    makedirs,
    open,
    replace,
    system_provider,
    truncate,
    unlink,
)

__all__ = [
    "FaultyFsProvider",
    "FsOp",
    "FsProvider",
    "RecordingFsProvider",
    "active",
    "fsync",
    "fsync_dir",
    "install",
    "makedirs",
    "open",
    "replace",
    "system_provider",
    "truncate",
    "unlink",
]
