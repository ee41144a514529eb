"""The storage plane's filesystem seam: the port of
``chunky_bits_tpu/utils/fsio.py`` (re-exported whole by ``file/fsio.py``).

Every durability-relevant filesystem op of the storage plane (the
write-mode ``open``, ``replace`` for atomic publication, ``unlink``,
``truncate``, ``makedirs``, ``fsync`` and ``fsync_dir``) resolves through
the active :class:`FsProvider` instead of calling ``os``/``open`` directly.
The default provider delegates to the OS and its ``open`` returns the
builtin file object.  :class:`RecordingFsProvider` captures the op stream
of a mutation (for a crash harness to replay its prefixes), and
:class:`FaultyFsProvider` scripts EIO/ENOSPC/short-write and failed-fsync
faults against the live code paths.

The provider swap is one attribute rebind; :class:`RecordingFsProvider`
guards its op list with a lock, since the storage plane calls the seam
from event loops and worker threads alike.  Stdlib only.

The op model: handle ops ``open`` (create/truncate/append flags),
``write``, ``flush``, ``fsync`` (the data barrier) and ``close``; name ops
``replace``, ``unlink``, ``mkdir`` and ``fsync_dir`` (the directory-entry
barrier).
"""

from __future__ import annotations

import builtins
import errno as _errno
import os
import threading
from typing import IO, Any, NamedTuple, Optional

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


class FsProvider:
    """Direct passthrough to the OS: the zero-surprise default.  Each
    method is one extra call frame over the primitive it wraps;
    ``open`` returns the builtin file object itself so the hot write
    paths carry no wrapper."""

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        return builtins.open(path, mode, **kwargs)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def unlink(self, path: str) -> None:
        os.unlink(path)

    def truncate(self, path: str, length: int) -> None:
        os.truncate(path, length)

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def fsync(self, f: IO[Any]) -> None:
        """Flush-then-fsync: the file *data* durability barrier.  A
        raised error here means the bytes may NOT be durable — callers
        must abort the publication they were about to make, never
        swallow it and publish anyway (failed-fsync poisoning;
        sim/crash.py scripts this exact fault)."""
        f.flush()
        os.fsync(f.fileno())

    def fsync_dir(self, path: str) -> None:
        """Directory-entry durability barrier: fsync the directory so
        a completed rename/create inside it survives power loss.  The
        storage plane runs this after metadata publication and the
        compaction journal swap (acknowledged-write durability); the
        per-chunk publication path deliberately does NOT (flush-only —
        file/slab.py's documented tradeoff)."""
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


class FsOp(NamedTuple):
    """One recorded durability op.  ``fid`` identifies the open handle
    (inode identity across renames — a write after a dropped rename
    must land on the inode it was issued against, not whatever the
    name points at in the crash image); name ops carry ``fid=-1``."""

    op: str          # open|write|flush|fsync|close|replace|unlink|
    #                  mkdir|fsync_dir|truncate
    path: str        # recording-root-relative posix path (dst for
    #                  replace)
    fid: int         # handle id for handle ops, -1 for name ops
    data: bytes      # write payload ('' otherwise)
    aux: str         # open: flags 'c'(reate)/'t'(runcate)/'a'(ppend);
    #                  replace: src relpath; truncate: str(length)


def _mode_flags(mode: str) -> tuple[bool, str]:
    """(is_write_mode, open-op aux flags) for a builtin-open mode."""
    write = any(c in mode for c in "wax+")
    flags = ""
    if any(c in mode for c in "wax"):
        flags += "c"
    if "w" in mode:
        flags += "t"
    if "a" in mode:
        flags += "a"
    return write, flags


class _RecordingFile:
    """Wraps a real file handle, mirroring writes/flushes into the
    recorder's op stream.  Reads/seeks/tells delegate untouched (the
    journal's torn-tail probe seeks and reads through its append
    handle).  Text-mode payloads are recorded encoded."""

    def __init__(self, real: IO[Any], provider: "RecordingFsProvider",
                 fid: int, rel: str) -> None:
        self._real = real
        self._provider = provider
        self._fid = fid
        self._rel = rel

    # ---- mirrored ops ----

    def write(self, data: Any) -> int:
        payload = data.encode("utf-8") if isinstance(data, str) \
            else bytes(data)
        n = self._real.write(data)
        self._provider.record(
            FsOp("write", self._rel, self._fid, payload, ""))
        return n

    def flush(self) -> None:
        self._real.flush()
        self._provider.record(
            FsOp("flush", self._rel, self._fid, b"", ""))

    def truncate(self, size: Optional[int] = None) -> int:
        n = self._real.truncate(size)
        self._provider.record(FsOp("truncate", self._rel, self._fid,
                                   b"", str(n)))
        return n

    def close(self) -> None:
        if not self._real.closed:
            self._real.close()
            self._provider.record(
                FsOp("close", self._rel, self._fid, b"", ""))

    # ---- delegation ----

    def read(self, *a: Any) -> Any:
        return self._real.read(*a)

    def seek(self, *a: Any) -> int:
        return self._real.seek(*a)

    def tell(self) -> int:
        return self._real.tell()

    def fileno(self) -> int:
        return self._real.fileno()

    def writable(self) -> bool:
        return self._real.writable()

    def readable(self) -> bool:
        return self._real.readable()

    @property
    def closed(self) -> bool:
        return self._real.closed

    @property
    def name(self) -> Any:
        return self._real.name

    def __enter__(self) -> "_RecordingFile":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class RecordingFsProvider(FsProvider):
    """Captures the durability-op stream of every seam call under
    ``root``; ops outside ``root`` pass through unrecorded (a cluster
    mutation records one simulated "node" — the other destinations
    stay real, so a crash image rolls back exactly one failure
    domain).  Thread-safe: slab appends ride ``asyncio.to_thread``."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.ops: list[FsOp] = []
        self._lock = threading.Lock()
        self._next_fid = 0

    def _rel(self, path: str) -> Optional[str]:
        """Recording-root-relative posix path, or None when outside."""
        abspath = os.path.abspath(path)
        if abspath == self.root:
            return "."
        prefix = self.root + os.sep
        if not abspath.startswith(prefix):
            return None
        return abspath[len(prefix):].replace(os.sep, "/")

    def record(self, op: FsOp) -> None:
        with self._lock:
            self.ops.append(op)

    # ---- provider surface ----

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        real = builtins.open(path, mode, **kwargs)
        rel = self._rel(path)
        write, flags = _mode_flags(mode)
        if rel is None or not write:
            return real
        with self._lock:
            fid = self._next_fid
            self._next_fid += 1
            self.ops.append(FsOp("open", rel, fid, b"", flags))
        return _RecordingFile(real, self, fid, rel)  # type: ignore[return-value]

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)
        rel_src, rel_dst = self._rel(src), self._rel(dst)
        if rel_src is not None and rel_dst is not None:
            self.record(FsOp("replace", rel_dst, -1, b"", rel_src))

    def unlink(self, path: str) -> None:
        os.unlink(path)
        rel = self._rel(path)
        if rel is not None:
            self.record(FsOp("unlink", rel, -1, b"", ""))

    def truncate(self, path: str, length: int) -> None:
        os.truncate(path, length)
        rel = self._rel(path)
        if rel is not None:
            self.record(FsOp("truncate", rel, -1, b"", str(length)))

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)
        rel = self._rel(path)
        if rel is not None:
            self.record(FsOp("mkdir", rel, -1, b"", ""))

    def fsync(self, f: IO[Any]) -> None:
        if isinstance(f, _RecordingFile):
            f.flush()  # records the flush half
            os.fsync(f.fileno())
            self.record(FsOp("fsync", f._rel, f._fid, b"", ""))
        else:
            super().fsync(f)

    def fsync_dir(self, path: str) -> None:
        super().fsync_dir(path)
        rel = self._rel(path)
        if rel is not None:
            self.record(FsOp("fsync_dir", rel, -1, b"", ""))


class _FaultyFile:
    """Wraps a real file so write/flush can be scripted to fail; the
    short-write fault lands a real partial tail first (the ENOSPC
    shape: some bytes reached the file, then the disk filled)."""

    def __init__(self, real: IO[Any], provider: "FaultyFsProvider",
                 path: str) -> None:
        self._real = real
        self._provider = provider
        self._path = path

    def write(self, data: Any) -> int:
        # a firing short-write fault lands the partial tail on the real
        # file inside check(), then raises — so reaching the next line
        # means no fault fired
        self._provider.check("write", self._path, payload=data,
                             real=self._real)
        return self._real.write(data)

    def flush(self) -> None:
        self._provider.check("flush", self._path)
        self._real.flush()

    def truncate(self, size: Optional[int] = None) -> int:
        self._provider.check("truncate", self._path)
        return self._real.truncate(size)

    def close(self) -> None:
        self._real.close()

    def read(self, *a: Any) -> Any:
        return self._real.read(*a)

    def seek(self, *a: Any) -> int:
        return self._real.seek(*a)

    def tell(self) -> int:
        return self._real.tell()

    def fileno(self) -> int:
        return self._real.fileno()

    @property
    def closed(self) -> bool:
        return self._real.closed

    def __enter__(self) -> "_FaultyFile":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


class FaultyFsProvider(FsProvider):
    """Scripted disk faults against LIVE code paths: the ``fail_op``-th
    matching op raises ``OSError(errno_code)``; a ``short_bytes`` write
    fault lands that many real bytes first, then raises — the
    ENOSPC-mid-write shape the slab append must truncate away.  A
    failed ``fsync`` raising here is the poisoning probe: the caller
    must abort its publication, never report success."""

    def __init__(self, fail_op: str, *, path_suffix: str = "",
                 errno_code: int = _errno.EIO, skip: int = 0,
                 short_bytes: Optional[int] = None) -> None:
        self.fail_op = fail_op
        self.path_suffix = path_suffix
        self.errno_code = errno_code
        self.skip = skip
        self.short_bytes = short_bytes
        self.fired = 0

    def check(self, op: str, path: str, payload: Any = None,
              real: Optional[IO[Any]] = None) -> None:
        """Raise the scripted fault when (op, path) matches — for a
        short write, landing the partial tail on ``real`` first (the
        ENOSPC-mid-write shape); returns normally only when no fault
        fires."""
        if op != self.fail_op:
            return
        if self.path_suffix and not str(path).endswith(self.path_suffix):
            return
        if self.skip > 0:
            self.skip -= 1
            return
        self.fired += 1
        if self.short_bytes is not None and op == "write" \
                and real is not None and payload is not None:
            raw = payload.encode("utf-8") if isinstance(payload, str) \
                else bytes(payload)
            real.write(raw[:self.short_bytes])
            real.flush()
        raise OSError(self.errno_code,
                      f"injected {os.strerror(self.errno_code)} on "
                      f"{op} {path}")

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        self.check("open", path)
        real = builtins.open(path, mode, **kwargs)
        write, _flags = _mode_flags(mode)
        if not write:
            return real
        return _FaultyFile(real, self, path)  # type: ignore[return-value]

    def replace(self, src: str, dst: str) -> None:
        self.check("replace", dst)
        os.replace(src, dst)

    def unlink(self, path: str) -> None:
        self.check("unlink", path)
        os.unlink(path)

    def truncate(self, path: str, length: int) -> None:
        self.check("truncate", path)
        os.truncate(path, length)

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        self.check("mkdir", path)
        os.makedirs(path, exist_ok=exist_ok)

    def fsync(self, f: IO[Any]) -> None:
        name = getattr(f, "name", "")
        if isinstance(f, _FaultyFile):
            name = f._path
        self.check("fsync", str(name))
        f.flush()
        os.fsync(f.fileno())

    def fsync_dir(self, path: str) -> None:
        self.check("fsync_dir", path)
        super().fsync_dir(path)


_SYSTEM = FsProvider()
_ACTIVE: FsProvider = _SYSTEM


def system_provider() -> FsProvider:
    """The always-direct passthrough provider."""
    return _SYSTEM


def active() -> FsProvider:
    """The currently installed provider (passthrough by default)."""
    return _ACTIVE


def install(provider: Optional[FsProvider]) -> FsProvider:
    """Swap the process-wide active provider; returns the previous one
    so callers can restore it (``install(None)`` restores the
    passthrough).  The crash harness brackets every recorded mutation
    with ``prev = install(RecordingFsProvider(root))`` /
    ``install(prev)`` — production code never calls this."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = provider if provider is not None else _SYSTEM
    return previous


def open(path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
    """Seam-routed ``open`` — THE open every storage-plane write path
    uses (lint rule CB109 flags direct write-mode ``open`` calls in
    those modules).  Read-mode opens may use it too; only write modes
    are recorded."""
    return _ACTIVE.open(path, mode, **kwargs)


def replace(src: str, dst: str) -> None:
    """Seam-routed ``os.replace`` (atomic publication rename)."""
    _ACTIVE.replace(src, dst)


def unlink(path: str) -> None:
    """Seam-routed ``os.unlink``."""
    _ACTIVE.unlink(path)


def truncate(path: str, length: int) -> None:
    """Seam-routed ``os.truncate`` (the short-write tail reclaim)."""
    _ACTIVE.truncate(path, length)


def makedirs(path: str, exist_ok: bool = True) -> None:
    """Seam-routed ``os.makedirs``."""
    _ACTIVE.makedirs(path, exist_ok=exist_ok)


def fsync(f: IO[Any]) -> None:
    """Seam-routed flush+fsync data barrier; see
    :meth:`FsProvider.fsync` for the abort-on-failure contract."""
    _ACTIVE.fsync(f)


def fsync_dir(path: str) -> None:
    """Seam-routed directory-entry barrier; see
    :meth:`FsProvider.fsync_dir`."""
    _ACTIVE.fsync_dir(path)
