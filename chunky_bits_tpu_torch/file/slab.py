"""Packed slab chunk store: many chunks per file (the port of
``chunky_bits_tpu/file/slab.py``).

A slab store packs chunks into a few large append-only files and keeps
the name -> extent mapping in its own index, so a chunk read costs one
indexed ``pread`` and a GC enumeration one index scan, where the
reference stores one chunk per file (src/file/location.rs:311-343).

On-disk layout, rooted at a directory, byte-for-byte the JAX package's::

    <root>/slab-000001.slab   append-only chunk bytes (no framing)
    <root>/index.jsonl        append-only index journal, one JSON/line
    <root>/.lock              flock target for cross-process appends

Publication: chunk bytes are appended to the active slab and flushed,
THEN one complete journal line ``{"o": "p", "n": <name>, "s": <slab>,
"f": <offset>, "l": <len>, "t": <unix>}`` is appended in a single write.
A chunk is visible if and only if its journal line is written, so a
crashed process leaves at worst unreferenced slab tail bytes (reclaimed
by compaction) and possibly a torn final journal line, which every
reader ignores and the next append terminates.  Appends flush without
an fsync, the repo's per-chunk discipline (``_publish_atomically``):
after a power loss the journal may reference bytes that never reached
the disk, which content addressing detects on read and the scrub daemon
repairs.  ``compact()`` fsyncs its data and the store directory around
the atomic journal swap.  A short append (ENOSPC mid-write) truncates
its partial tail before surfacing.  Deletion appends ``{"o": "d", "n":
<name>}``: the extent goes dead and compaction reclaims its bytes.
Every durability op goes through the filesystem seam (``file/fsio.py``).

Concurrency: in-process access is serialized by a ``threading.Lock``
(the methods are synchronous; async callers hop them off the loop);
cross-process appenders (gateway workers sharing a store) serialize on
``flock(<root>/.lock)``.  Readers take no lock: extents are write-once
and the index refresh tolerates a torn tail.  A mmap view held across a
compaction keeps the old slab's inode alive; views are read-only.

``Location`` (file/location.py) parses ``slab:<root>/<name>`` and serves
the whole verb surface over this store.
"""

from __future__ import annotations

import io
import json
import mmap
import os
import re
import threading
import time
from typing import Iterator, NamedTuple, Optional

from chunky_bits_tpu_torch.utils import fsio as _fsio

#: rollover threshold for the active slab file; a few hundred MiB keeps
#: per-slab mmap windows and compaction copies bounded while still
#: packing ~10^5 small chunks per descriptor
DEFAULT_SLAB_MAX_BYTES = 256 << 20

JOURNAL_NAME = "index.jsonl"
LOCK_NAME = ".lock"

_SLAB_RE = re.compile(r"^slab-(\d{6})\.slab$")


class SlabExtent(NamedTuple):
    """One live chunk inside a slab file."""

    slab: str  # slab file basename
    offset: int
    length: int
    published: float  # unix time of the journal commit (GC grace)


class SlabStoreError(OSError):
    """Store-level failure surfaced to the Location plane (a subclass of
    OSError so the existing ``except OSError -> LocationError`` seams
    catch it unchanged)."""


def _parse_slab_index(name: str) -> Optional[int]:
    m = _SLAB_RE.match(name)
    return int(m.group(1)) if m else None


def _slab_name(index: int) -> str:
    return f"slab-{index:06d}.slab"


class _Flock:
    """``flock`` guard over ``<root>/.lock`` for cross-process append
    serialization; a context manager over one kept-open fd."""

    def __init__(self, root: str) -> None:
        self._path = os.path.join(root, LOCK_NAME)
        self._fd: Optional[int] = None

    def __enter__(self) -> "_Flock":
        import fcntl

        # the flock target carries no data: creating it is idempotent
        # and indifferent to crashes, so it stays off the fsio seam
        # lint: fsio-ok the flock target carries no data — creating it
        # is idempotent and crash-indifferent, so the harness has
        # nothing to record or replay here
        self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except OSError:
            os.close(self._fd)
            self._fd = None
            raise
        return self

    def __exit__(self, *exc: object) -> None:
        import fcntl

        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None


class SlabStore:
    """One packed chunk store rooted at a directory.

    Every method is synchronous (bounded local file I/O) — async
    callers hop through ``asyncio.to_thread`` / the host pipeline, the
    same discipline as the one-file-per-chunk local plane.  Instances
    are process-shared per root (:func:`get_store`) so all loops and
    worker threads of a process see one coherent in-memory index.
    """

    def __init__(self, root: str,
                 slab_max_bytes: int = DEFAULT_SLAB_MAX_BYTES) -> None:
        self.root = os.path.abspath(root)
        self.slab_max_bytes = int(slab_max_bytes)
        self._lock = threading.Lock()
        self._live: dict[str, SlabExtent] = {}
        self._dead_bytes = 0
        self._journal_pos = 0  # bytes of the journal applied so far
        self._journal_id: Optional[int] = None  # st_ino of that journal
        self._loaded = False

    # ---- paths ----

    def journal_path(self) -> str:
        return os.path.join(self.root, JOURNAL_NAME)

    def slab_path(self, slab: str) -> str:
        return os.path.join(self.root, slab)

    # ---- journal loading / refresh (no lock file needed: reads
    #      tolerate a torn tail and extents are write-once) ----

    def _reset_locked(self) -> None:
        self._live.clear()
        self._dead_bytes = 0
        self._journal_pos = 0
        self._journal_id = None

    def _apply_line_locked(self, line: bytes) -> None:
        try:
            obj = json.loads(line)
        except ValueError:
            return  # foreign garbage: skip, like GC skips unknown names
        op = obj.get("o")
        name = obj.get("n")
        if not isinstance(name, str):
            return
        if op == "p":
            old = self._live.get(name)
            if old is not None:
                self._dead_bytes += old.length
            try:
                self._live[name] = SlabExtent(
                    str(obj["s"]), int(obj["f"]), int(obj["l"]),
                    float(obj.get("t", 0.0)))
            except (KeyError, TypeError, ValueError):
                return
        elif op == "d":
            old = self._live.pop(name, None)
            if old is not None:
                self._dead_bytes += old.length

    def _refresh_locked(self) -> None:
        """Apply journal bytes written since the last look (another
        process appended), or reload from scratch when the journal was
        swapped (compaction) or truncated."""
        path = self.journal_path()
        try:
            st = os.stat(path)
        except OSError:
            if self._loaded and self._journal_id is not None:
                self._reset_locked()  # journal vanished: empty store
            self._loaded = True
            return
        if (self._journal_id != st.st_ino
                or st.st_size < self._journal_pos):
            self._reset_locked()
            self._journal_id = st.st_ino
        self._loaded = True
        if st.st_size == self._journal_pos:
            return
        with open(path, "rb") as f:
            f.seek(self._journal_pos)
            tail = f.read()
        # whole lines only: a torn final line (crashed writer) stays
        # unapplied and unconsumed until its writer — or compaction —
        # completes it
        end = tail.rfind(b"\n")
        if end < 0:
            return
        for line in tail[:end].splitlines():
            self._apply_line_locked(line)
        self._journal_pos += end + 1

    # ---- lookups ----

    def lookup(self, name: str) -> Optional[SlabExtent]:
        with self._lock:
            self._refresh_locked()
            return self._live.get(name)

    def extent_path(self, name: str) -> Optional[tuple[str, int, int]]:
        """(absolute slab path, offset, length) of a live chunk — the
        gateway's zero-copy (sendfile) addressing — or None."""
        ext = self.lookup(name)
        if ext is None:
            return None
        return (self.slab_path(ext.slab), ext.offset, ext.length)

    def live_names(self) -> list[str]:
        with self._lock:
            self._refresh_locked()
            return list(self._live)

    def live_extents(self) -> list[tuple[str, SlabExtent]]:
        with self._lock:
            self._refresh_locked()
            return sorted(self._live.items())

    def live_bytes(self) -> int:
        with self._lock:
            self._refresh_locked()
            return sum(e.length for e in self._live.values())

    def dead_bytes(self) -> int:
        with self._lock:
            self._refresh_locked()
            return self._dead_bytes

    def slab_files(self) -> list[str]:
        """Basenames of the slab files currently on disk, ordered."""
        try:
            entries = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in entries
                      if _parse_slab_index(n) is not None)

    # ---- reads ----

    def pread(self, name: str, start: int = 0,
              length: Optional[int] = None) -> bytes:
        """Chunk bytes (or a sub-range) by one positioned read.  Raises
        ``FileNotFoundError`` for unknown/dead names so the Location
        plane surfaces the same errno as a missing chunk file."""
        ext = self.lookup(name)
        if ext is None:
            raise FileNotFoundError(
                f"no live chunk {name!r} in slab store {self.root}")
        start = max(start, 0)
        avail = max(ext.length - start, 0)
        n = avail if length is None else max(min(length, avail), 0)
        if n == 0:
            return b""
        with open(self.slab_path(ext.slab), "rb") as f:
            f.seek(ext.offset + start)
            return f.read(n)

    def map_view(self, name: str, start: int = 0,
                 length: Optional[int] = None) -> Optional[memoryview]:
        """Zero-copy page-cache view of a live extent (or a sub-range
        inside it), or None when unmappable / out of the extent's
        bounds — mirroring ``Location.read_view_mapper``'s contract
        that the generic read path owns short-range semantics.  The
        returned view keeps its backing map alive; compaction renames
        a fresh journal in and unlinks old slabs, so a held view pins
        the old inode rather than ever observing torn bytes."""
        ext = self.lookup(name)
        if ext is None:
            return None
        if start < 0 or (length is not None and length < 0):
            return None
        end = ext.length if length is None else start + length
        if start > ext.length or end > ext.length:
            return None
        try:
            with open(self.slab_path(ext.slab), "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError, io.UnsupportedOperation):
            return None
        if ext.offset + end > len(mm):
            return None  # journal ahead of slab bytes: corrupt store
        return memoryview(mm)[ext.offset + start:ext.offset + end]

    # ---- writes ----

    def _active_slab_locked(self, incoming: int) -> tuple[str, int]:
        """(basename, current size) of the slab file the next append
        lands in, rolling over past ``slab_max_bytes``."""
        slabs = self.slab_files()
        if slabs:
            current = slabs[-1]
            try:
                size = os.path.getsize(self.slab_path(current))
            except OSError:
                size = 0
            if size + incoming <= self.slab_max_bytes or size == 0:
                return current, size
            nxt = (_parse_slab_index(current) or 0) + 1
            return _slab_name(nxt), 0
        return _slab_name(1), 0

    def _journal_append_locked(self, record: dict) -> None:
        line = (json.dumps(record, separators=(",", ":")) + "\n").encode()
        # 'a+b', not write-only: the torn-tail probe reads the last
        # byte through the same append handle (O_APPEND keeps every
        # write at EOF regardless of the probe's seek).  Unbuffered:
        # the probe must read exactly ONE byte (a buffered handle
        # would drag a full block through the filesystem per append),
        # and the line must land in one write syscall.  Seam-routed, so
        # a recording provider sees the commit.
        with _fsio.open(self.journal_path(), "a+b", buffering=0) as f:
            size = os.fstat(f.fileno()).st_size
            if size > 0:
                f.seek(size - 1)
                if f.read(1) != b"\n":
                    # a crashed writer left a torn final line:
                    # terminate it first so this record starts a fresh
                    # line instead of merging into (and dying with)
                    # the fragment
                    line = b"\n" + line
            f.write(line)
            if self._journal_id is None:
                self._journal_id = os.fstat(f.fileno()).st_ino
        # the caller applies this record in-memory; everything between
        # the last refresh position and the pre-append size was at most
        # the torn fragment just terminated (refresh consumed every
        # complete line under this same flock), so the applied frontier
        # is exactly the new end of file
        self._journal_pos = size + len(line)

    def append(self, name: str, data: bytes) -> SlabExtent:
        """Publish one chunk: slab append, flush, journal commit.  An
        existing live extent of the same name is superseded (it goes
        dead) — content-addressed callers normally short-circuit on
        ``file_exists`` first, and resilver's overwrite relies on the
        supersede."""
        if "/" in name or name in (".", "..", ""):
            raise SlabStoreError(f"invalid slab chunk name {name!r}")
        view = memoryview(data)
        _fsio.makedirs(self.root)
        with self._lock, _Flock(self.root):
            self._refresh_locked()
            slab, offset = self._active_slab_locked(len(view))
            path = self.slab_path(slab)
            with _fsio.open(path, "ab") as f:
                # 'ab' positions at EOF; trust the fd, not the earlier
                # stat (another writer under a different root handle
                # could have raced the rollover decision, never the
                # bytes — appends are flock-serialized)
                offset = f.tell()
                try:
                    f.write(view)
                    f.flush()
                except OSError:
                    # ENOSPC/EIO mid-append: a short write left a
                    # partial tail past `offset`.  Close (a retried
                    # flush may fail again — the bytes are already
                    # doomed) and truncate the tail away so the next
                    # append's offset accounting never packs around
                    # garbage; nothing was journaled, so the failed
                    # append is invisible to every reader
                    try:
                        f.close()
                    except OSError:
                        pass
                    try:
                        _fsio.truncate(path, offset)
                    except OSError:
                        pass  # reclaim is best-effort: the tail is
                        # unreferenced either way, just unreclaimed
                    raise
            # wall-clock publish stamp for humans (the
            # journal's `t` field is operator forensics, never a
            # duration — it must stay real even inside a simulation)
            # lint: clock-ok wall-clock publish stamp for humans (the
            # journal's `t` field is operator forensics, never a
            # duration — it must stay real even inside a simulation)
            published = time.time()
            record = {"o": "p", "n": name, "s": slab, "f": offset,
                      "l": len(view), "t": published}
            self._journal_append_locked(record)
            old = self._live.get(name)
            if old is not None:
                self._dead_bytes += old.length
            ext = SlabExtent(slab, offset, len(view), published)
            self._live[name] = ext
            return ext

    def mark_dead(self, name: str) -> None:
        """GC a chunk: the extent goes dead for compaction.  Raises
        ``FileNotFoundError`` when there is no live extent, matching
        ``os.remove`` on a missing chunk file."""
        with self._lock, _Flock(self.root):
            self._refresh_locked()
            ext = self._live.get(name)
            if ext is None:
                raise FileNotFoundError(
                    f"no live chunk {name!r} in slab store {self.root}")
            self._journal_append_locked({"o": "d", "n": name})
            del self._live[name]
            self._dead_bytes += ext.length

    # ---- compaction ----

    def compact(self) -> dict:
        """Reclaim dead extents: copy every live extent into fresh slab
        files, atomically swap in a rewritten journal (data fsync'd
        before the rename, the store directory fsync'd after it),
        unlink the old slabs.  The copy-then-publish shape of the
        CLI's ``migrate``: data lands first, the single rename makes
        it authoritative, and a crash at any point leaves a store that
        reads either entirely pre- or entirely post-compaction.  A
        failing fsync aborts the swap loudly before the in-memory
        state flips.  Returns ``{"copied_bytes", "reclaimed_bytes",
        "live_chunks"}``."""
        with self._lock, _Flock(self.root):
            self._refresh_locked()
            old_slabs = self.slab_files()
            base = (_parse_slab_index(old_slabs[-1]) or 0) + 1 \
                if old_slabs else 1
            copied = 0
            out_slab = _slab_name(base)
            out_path = self.slab_path(out_slab)
            new_live: dict[str, SlabExtent] = {}
            lines: list[str] = []
            out = _fsio.open(out_path, "wb")
            try:
                for name, ext in sorted(self._live.items()):
                    if out.tell() + ext.length > self.slab_max_bytes \
                            and out.tell() > 0:
                        _fsio.fsync(out)
                        out.close()
                        base += 1
                        out_slab = _slab_name(base)
                        out_path = self.slab_path(out_slab)
                        out = _fsio.open(out_path, "wb")
                    offset = out.tell()
                    with open(self.slab_path(ext.slab), "rb") as src:
                        src.seek(ext.offset)
                        remaining = ext.length
                        while remaining > 0:
                            buf = src.read(min(remaining, 1 << 20))
                            if not buf:
                                raise SlabStoreError(
                                    f"slab {ext.slab} truncated under "
                                    f"live extent {name}")
                            out.write(buf)
                            remaining -= len(buf)
                    copied += ext.length
                    new_ext = SlabExtent(out_slab, offset, ext.length,
                                         ext.published)
                    new_live[name] = new_ext
                    lines.append(json.dumps(
                        {"o": "p", "n": name, "s": out_slab,
                         "f": offset, "l": ext.length,
                         "t": ext.published},
                        separators=(",", ":")))
                # a failing fsync here (or on the journal temp below)
                # propagates and ABORTS the swap: the old journal stays
                # authoritative, nothing is published against bytes
                # that may never have reached the platter
                _fsio.fsync(out)
            finally:
                out.close()
            if not new_live:
                # nothing live: the fresh slab is empty — drop it
                # rather than leave a zero-byte rollover target
                try:
                    _fsio.unlink(out_path)
                except OSError:
                    pass
            payload = ("".join(line + "\n" for line in lines)).encode()
            tmp = self.journal_path() + f".compact.{os.getpid()}"
            with _fsio.open(tmp, "wb") as f:
                f.write(payload)
                _fsio.fsync(f)
            _fsio.replace(tmp, self.journal_path())
            # directory-entry barrier: without it the completed rename
            # is not power-loss durable — a post-compaction power cut
            # could resurrect the old journal while later appends
            # landed against the new one.  A failure
            # raises BEFORE the in-memory state flips, so the store
            # re-reads whichever journal the disk actually holds.
            _fsio.fsync_dir(self.root)
            reclaimed = self._dead_bytes
            self._live = new_live
            self._dead_bytes = 0
            self._journal_pos = len(payload)
            self._journal_id = os.stat(self.journal_path()).st_ino
            keep = set(e.slab for e in new_live.values())
            for slab in old_slabs:
                if slab not in keep:
                    try:
                        _fsio.unlink(self.slab_path(slab))
                    except OSError:
                        pass  # still mapped elsewhere is fine; orphaned
            return {"copied_bytes": copied,
                    "reclaimed_bytes": reclaimed,
                    "live_chunks": len(new_live)}

    def stats(self) -> dict:
        with self._lock:
            self._refresh_locked()
            return {
                "root": self.root,
                "live_chunks": len(self._live),
                "live_bytes": sum(e.length for e in self._live.values()),
                "dead_bytes": self._dead_bytes,
                "slab_files": len(self.slab_files()),
            }


def is_slab_root(path: str) -> bool:
    """True when ``path`` is (or is being used as) a slab store root —
    its journal exists.  The GC uses this to pick index enumeration
    over the dirent walk."""
    return os.path.isfile(os.path.join(path, JOURNAL_NAME))


#: process-shared stores keyed by realpath.
# deliberately process-wide, NOT per-loop: the
# store serializes cross-thread access with its own threading.Lock and
# cross-process access with flock, and every loop/worker of a process
# must see one coherent index per root (two instances over one root
# would race their rollover decisions)
# lint: loop-shared-ok deliberately process-wide, NOT per-loop: the
# store serializes cross-thread access with its own threading.Lock and
# cross-process access with flock, and every loop/worker of a process
# must see one coherent index per root (two instances over one root
# would race their rollover decisions)
_STORES: dict[str, SlabStore] = {}
_STORES_LOCK = threading.Lock()


def get_store(root: str) -> SlabStore:
    """The process-shared :class:`SlabStore` for a root directory."""
    key = os.path.realpath(root)
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = _STORES[key] = SlabStore(root)
        return store
