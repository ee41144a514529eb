"""Indexed metadata plane: append-only namespace log + compacting index
(the port of ``chunky_bits_tpu/cluster/meta_log.py``).

``file/slab.py``'s discipline applied to file references: refs are
appended to a few large log files, and the name -> (offset/len, publish
generation, publish time, tombstone) mapping lives in an append-only
journal and an in-memory compacting index, so every namespace question
(``list``, prefix scan, the scrub pre-scan, the GC liveness walk) is an
index scan, where the reference keeps one YAML file per reference
(src/cluster/metadata.rs:94-205).

On-disk layout, rooted at a directory, byte-for-byte the JAX package's::

    <root>/refs-000001.log   append-only serialized ref bytes (no framing)
    <root>/meta.jsonl        append-only index journal, one JSON/line
    <root>/.lock             flock target for cross-process appends

Journal records (one complete JSON line each)::

    {"o": "p", "n": <name>, "g": <gen>, "s": <log>, "f": <off>,
     "l": <len>, "t": <unix>,
     "h": [<hash>...], "nk": [[<kind>, <node>]...]}    publish
    {"o": "d", "n": <name>, "g": <gen>, "t": <unix>}   tombstone
    {"o": "g", "g": <gen>}             generation floor (compaction)

The optional ``h``/``nk`` fields are the index projection of a file
reference: its chunk hashes in display form and the health node keys
(``cluster.health.location_key``) of every replica, taken at publish
time.  They make the scrub pre-scan and the GC liveness walk pure index
scans (:meth:`MetadataLog.namespace_nodes`,
:meth:`MetadataLog.namespace_hashes`); a live entry without one makes
those report "unavailable", and the caller reads the full snapshot.

Publication is the cluster's write acknowledgment, so unlike the slab's
flush-only chunk appends every publish is power-loss durable before it
returns: the ref bytes are appended and fsynced, then the journal line
is appended in one write and fsynced, with a directory fsync whenever
the append created a file.  No fsync is dropped or deferred.  A crashed
writer leaves at worst unreferenced log tail bytes and a torn final
journal line, which readers ignore and the next append terminates; a
short append (ENOSPC) truncates its partial tail.  Every durability op
goes through the filesystem seam (``file/fsio.py``).

Every publish and tombstone carries a per-store generation;
``changes(since_generation)`` is the bounded tail feed the scrub daemon
uses to visit fresh writes first, and compaction writes a ``{"o": "g"}``
floor record so the counter never runs backwards.

Concurrency: a ``threading.Lock`` in process (async callers hop through
``asyncio.to_thread``), ``flock(<root>/.lock)`` across processes (the
slab's ``_Flock``), no lock for readers.

``MetadataLog`` (bottom) is the ``metadata: {type: meta-log, ...}``
store (``kind:`` is an alias of the tag) with the ``write``/``read``/
``list``/``to_obj`` contract of ``MetadataPath``, plus
``namespace_snapshot()``, ``read_objs()`` and ``changes()``.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import yaml

from chunky_bits_tpu_torch.errors import (
    LocationError,
    MetadataReadError,
    SerdeError,
)
from chunky_bits_tpu_torch.file.slab import _Flock
from chunky_bits_tpu_torch.utils import fsio as _fsio

#: rollover threshold for the active ref log; refs are small (KBs), so
#: 64 MiB packs ~10^4-10^5 refs per descriptor while keeping
#: compaction copies and snapshot read windows bounded
DEFAULT_LOG_MAX_BYTES = 64 << 20

JOURNAL_NAME = "meta.jsonl"
LOG_PREFIX = "refs-"
LOG_SUFFIX = ".log"

#: default bound on one ``changes()`` page — a tail feed, not a dump
DEFAULT_CHANGES_LIMIT = 1024


class MetaLogEntry(NamedTuple):
    """One name's latest state in the index."""

    generation: int
    log: str  # ref log basename ("" for a tombstone)
    offset: int
    length: int
    published: float  # unix time of the journal commit
    tombstone: bool
    #: index projection of the ref (journal ``h``/``nk``): chunk hashes
    #: in display form, and health node keys as (kind, node) pairs.
    #: None = published without one (foreign payload / older writer).
    hashes: Optional[tuple] = None
    nodes: Optional[tuple] = None


class ChangeRecord(NamedTuple):
    """One row of the ``changes(since_generation)`` tail feed."""

    name: str
    generation: int
    tombstone: bool
    published: float


class MetaLogError(OSError):
    """Store-level failure surfaced to the metadata plane (a subclass
    of OSError so the existing ``except OSError -> MetadataReadError``
    seams catch it unchanged)."""


def _parse_log_index(name: str) -> Optional[int]:
    if not (name.startswith(LOG_PREFIX) and name.endswith(LOG_SUFFIX)):
        return None
    digits = name[len(LOG_PREFIX):-len(LOG_SUFFIX)]
    if len(digits) == 6 and digits.isdigit():
        return int(digits)
    return None


def _log_name(index: int) -> str:
    return f"{LOG_PREFIX}{index:06d}{LOG_SUFFIX}"


def norm_name(path: str) -> str:
    """Canonical store key for a public path: normal components only
    (no traversal — the same rule as ``metadata._sub_path``), joined
    with "/".  "" is the namespace root."""
    return "/".join(p for p in str(path).split("/")
                    if p not in ("", ".", ".."))


def _parse_hashes(raw) -> Optional[tuple]:
    """Journal ``h`` field -> hashes tuple, None on absence/garbage."""
    if not isinstance(raw, list):
        return None
    return tuple(str(h) for h in raw)


def _parse_nodes(raw) -> Optional[tuple]:
    """Journal ``nk`` field -> ((kind, node), ...), None on
    absence/garbage — a malformed pair drops the whole projection (the
    consumer falls back to a full read) rather than a silently partial
    node set (which would mis-score the ref as healthier than it is)."""
    if not isinstance(raw, list):
        return None
    out = []
    for pair in raw:
        if not (isinstance(pair, (list, tuple)) and len(pair) == 2):
            return None
        out.append((str(pair[0]), str(pair[1])))
    return tuple(out)


def extract_index_meta(payload) -> tuple[Optional[list], Optional[list]]:
    """(chunk hashes, health node keys) of a file-reference payload, or
    (None, None) for anything that does not parse as one.  Runs at
    publish time — one ``FileReference.from_obj`` per write, amortized
    into the (fsync-bound) append — so every namespace-scale consumer
    afterwards reads the projection from the index instead of the log."""
    try:
        from chunky_bits_tpu_torch.cluster.health import location_key
        from chunky_bits_tpu_torch.file.file_reference import FileReference

        ref = FileReference.from_obj(payload)
        hashes: list[str] = []
        nodes: list[list[str]] = []
        seen: set = set()
        for part in ref.parts:
            for chunk in part.data + part.parity:
                hashes.append(str(chunk.hash))
                for location in chunk.locations:
                    key = location_key(location)
                    if key not in seen:
                        seen.add(key)
                        nodes.append([key[0], key[1]])
        return hashes, nodes
    # the projection is an optional accelerator:
    # ANY payload that is not a well-formed file reference (foreign
    # metadata, future schema) publishes without one and the fast
    # paths fall back — a failure here must never block the write ack
    # lint: broad-except-ok the projection is an optional accelerator:
    # ANY payload that is not a well-formed file reference (foreign
    # metadata, future schema) publishes without one and the fast
    # paths fall back — a failure here must never block the write ack
    except Exception:
        return None, None


class MetaLogStore:
    """One indexed metadata store rooted at a directory.

    Every method is synchronous (bounded local file I/O) — async
    callers hop through ``asyncio.to_thread``, the same discipline as
    ``SlabStore``.  Instances are process-shared per root
    (:func:`get_store`) so all loops and worker threads of a process
    see one coherent in-memory index.
    """

    def __init__(self, root: str,
                 log_max_bytes: int = DEFAULT_LOG_MAX_BYTES) -> None:
        self.root = os.path.abspath(root)
        self.log_max_bytes = int(log_max_bytes)
        self._lock = threading.Lock()
        #: latest state per name — live entries AND tombstones (the
        #: changes() feed needs deletions until compaction drops them)
        self._entries: dict[str, MetaLogEntry] = {}
        self._gen = 0
        self._dead_bytes = 0
        self._journal_pos = 0
        self._journal_id: Optional[int] = None
        self._loaded = False

    # ---- paths ----

    def journal_path(self) -> str:
        return os.path.join(self.root, JOURNAL_NAME)

    def log_path(self, log: str) -> str:
        return os.path.join(self.root, log)

    def log_files(self) -> list[str]:
        """Basenames of the ref log files currently on disk, ordered."""
        try:
            entries = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in entries
                      if _parse_log_index(n) is not None)

    # ---- journal loading / refresh (identical discipline to
    #      SlabStore: whole lines only, torn tails unconsumed) ----

    def _reset_locked(self) -> None:
        self._entries.clear()
        self._gen = 0
        self._dead_bytes = 0
        self._journal_pos = 0
        self._journal_id = None

    def _apply_line_locked(self, line: bytes) -> None:
        try:
            obj = json.loads(line)
        except ValueError:
            return  # foreign garbage: skip, like the slab journal does
        op = obj.get("o")
        if op == "g":
            try:
                self._gen = max(self._gen, int(obj["g"]))
            except (KeyError, TypeError, ValueError):
                pass
            return
        name = obj.get("n")
        if not isinstance(name, str):
            return
        try:
            gen = int(obj.get("g", 0))
            stamp = float(obj.get("t", 0.0))
        except (TypeError, ValueError):
            return
        old = self._entries.get(name)
        if op == "p":
            try:
                entry = MetaLogEntry(gen, str(obj["s"]), int(obj["f"]),
                                     int(obj["l"]), stamp, False,
                                     _parse_hashes(obj.get("h")),
                                     _parse_nodes(obj.get("nk")))
            except (KeyError, TypeError, ValueError):
                return
        elif op == "d":
            entry = MetaLogEntry(gen, "", 0, 0, stamp, True)
        else:
            return
        if old is not None and not old.tombstone:
            self._dead_bytes += old.length
        self._entries[name] = entry
        self._gen = max(self._gen, gen)

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

    # ---- lookups (all O(index): no dirents, no per-entry parses) ----

    def lookup(self, name: str) -> Optional[MetaLogEntry]:
        with self._lock:
            self._refresh_locked()
            entry = self._entries.get(norm_name(name))
            if entry is None or entry.tombstone:
                return None
            return entry

    def generation(self) -> int:
        with self._lock:
            self._refresh_locked()
            return self._gen

    def live_count(self) -> int:
        with self._lock:
            self._refresh_locked()
            return sum(1 for e in self._entries.values()
                       if not e.tombstone)

    def live_names(self) -> list[str]:
        with self._lock:
            self._refresh_locked()
            return sorted(n for n, e in self._entries.items()
                          if not e.tombstone)

    def dead_bytes(self) -> int:
        with self._lock:
            self._refresh_locked()
            return self._dead_bytes

    def prefix_names(self, prefix: str) -> list[str]:
        """Every live name under ``prefix`` (recursive), sorted — the
        no-dirent-walk namespace scan.  "" scans the whole store."""
        key = norm_name(prefix)
        want = key + "/" if key else ""
        with self._lock:
            self._refresh_locked()
            return sorted(
                n for n, e in self._entries.items()
                if not e.tombstone
                and (not want or n.startswith(want) or n == key))

    def list_children(self, path: str
                      ) -> Optional[tuple[str, list[tuple[str, str]]]]:
        """One-level listing at ``path``: ("file"|"directory", sorted
        [(kind, name), ...]) with directories synthesized from name
        prefixes, or None when the path names neither a live ref nor a
        populated directory.  The namespace root is always a (possibly
        empty) directory, like an existing-but-empty MetadataPath
        root."""
        key = norm_name(path)
        with self._lock:
            self._refresh_locked()
            entry = self._entries.get(key)
            if entry is not None and not entry.tombstone:
                return ("file", [])
            prefix = key + "/" if key else ""
            children: dict[str, str] = {}
            for name, e in self._entries.items():
                if e.tombstone or not name.startswith(prefix):
                    continue
                rest = name[len(prefix):]
                head, sep, _ = rest.partition("/")
                kind = "directory" if sep else "file"
                # a directory prefix wins over a same-named file (the
                # filesystem cannot even express that collision)
                if children.get(head) != "directory":
                    children[head] = kind
            if not children and key:
                return None
            out = [(children[name], name) for name in sorted(children)]
            return ("directory", out)

    def snapshot_entries(self) -> list[tuple[str, MetaLogEntry]]:
        """(name, entry) for every live ref, name-sorted — the index
        half of a namespace snapshot."""
        with self._lock:
            self._refresh_locked()
            return sorted((n, e) for n, e in self._entries.items()
                          if not e.tombstone)

    def index_meta(self) -> list[tuple]:
        """(name, hashes, nodes) for every live ref, name-sorted — the
        zero-read pre-scan surface (projection fields None where a
        publish carried none; consumers requiring them fall back)."""
        with self._lock:
            self._refresh_locked()
            return sorted((n, e.hashes, e.nodes)
                          for n, e in self._entries.items()
                          if not e.tombstone)

    def entries_for(self, names) -> list[tuple[str, MetaLogEntry]]:
        """Live index entries for ``names`` (input order, unknown and
        tombstoned names skipped) under ONE lock/refresh — the paged
        read path's batch lookup."""
        with self._lock:
            self._refresh_locked()
            out = []
            for name in names:
                key = norm_name(name)
                entry = self._entries.get(key)
                if entry is not None and not entry.tombstone:
                    out.append((key, entry))
            return out

    def changes(self, since_generation: int,
                limit: int = DEFAULT_CHANGES_LIMIT) -> list[ChangeRecord]:
        """Publishes/tombstones with generation > ``since_generation``,
        generation-ordered, at most ``limit`` rows — the bounded tail
        feed.  Entries superseded before compaction show only their
        LATEST generation (the index is compacting by construction);
        rows older than the last compaction's floor are gone, which a
        consumer observes as a gap it fills with a full snapshot."""
        with self._lock:
            self._refresh_locked()
            rows = [ChangeRecord(n, e.generation, e.tombstone,
                                 e.published)
                    for n, e in self._entries.items()
                    if e.generation > since_generation]
        rows.sort(key=lambda r: r.generation)
        return rows[:max(int(limit), 0)]

    # ---- reads ----

    def read_bytes(self, name: str) -> bytes:
        """Serialized ref bytes by one positioned read.  Raises
        ``FileNotFoundError`` for unknown/tombstoned names so the
        metadata plane surfaces the same errno as a missing ref
        file."""
        entry = self.lookup(name)
        if entry is None:
            raise FileNotFoundError(
                f"no ref {norm_name(name)!r} in meta log {self.root}")
        with open(self.log_path(entry.log), "rb") as f:
            f.seek(entry.offset)
            data = f.read(entry.length)
        if len(data) != entry.length:
            raise MetaLogError(
                f"log {entry.log} truncated under live ref "
                f"{norm_name(name)!r}")
        return data

    def read_many(self, entries: list[tuple[str, MetaLogEntry]]
                  ) -> list[tuple[str, bytes]]:
        """Ref bytes for many index entries, each log file opened ONCE
        and its referenced span read in ONE sequential read (then
        sliced per entry) — the snapshot contract that a pass reads
        each ref's bytes at most once from the log, with no per-entry
        syscalls.  Peak extra memory is one log file's span (bounded
        by ``log_max_bytes``), released before the next log."""
        by_log: dict[str, list[tuple[str, MetaLogEntry]]] = {}
        for name, entry in entries:
            by_log.setdefault(entry.log, []).append((name, entry))
        out: dict[str, bytes] = {}
        for log, group in sorted(by_log.items()):
            lo = min(e.offset for _n, e in group)
            hi = max(e.offset + e.length for _n, e in group)
            with open(self.log_path(log), "rb") as f:
                f.seek(lo)
                blob = f.read(hi - lo)
            if len(blob) != hi - lo:
                raise MetaLogError(
                    f"log {log} truncated under live refs "
                    f"({hi - lo} span, {len(blob)} read)")
            for name, entry in group:
                start = entry.offset - lo
                out[name] = blob[start:start + entry.length]
        return [(name, out[name]) for name, _ in entries]

    # ---- writes ----

    def _active_log_locked(self, incoming: int) -> tuple[str, int]:
        """(basename, current size) of the log file the next append
        lands in, rolling over past ``log_max_bytes``."""
        logs = self.log_files()
        if logs:
            current = logs[-1]
            try:
                size = os.path.getsize(self.log_path(current))
            except OSError:
                size = 0
            if size + incoming <= self.log_max_bytes or size == 0:
                return current, size
            nxt = (_parse_log_index(current) or 0) + 1
            return _log_name(nxt), 0
        return _log_name(1), 0

    def _journal_commit_locked(self, record: dict) -> bool:
        """Append one journal line and fsync it (the metadata plane's
        acked-durability contract — unlike the slab journal, this
        commit IS the write acknowledgment).  Same unbuffered 'a+b'
        torn-tail probe as ``SlabStore._journal_append_locked``: a
        crashed writer's torn final line is terminated so this record
        starts fresh instead of merging into (and dying with) the
        fragment.  Returns True when the append created the journal
        (the caller owes a directory fsync)."""
        line = (json.dumps(record, separators=(",", ":")) + "\n").encode()
        with _fsio.open(self.journal_path(), "a+b", buffering=0) as f:
            size = os.fstat(f.fileno()).st_size
            if size > 0:
                f.seek(size - 1)
                if f.read(1) != b"\n":
                    line = b"\n" + line
            f.write(line)
            # a failing fsync raises and ABORTS the publication — it
            # is never swallowed and assumed durable (the same rule as
            # MetadataPath.write's temp fsync)
            _fsio.fsync(f)
            if self._journal_id is None:
                self._journal_id = os.fstat(f.fileno()).st_ino
        self._journal_pos = size + len(line)
        return size == 0

    def append(self, name: str, data: bytes,
               hashes: Optional[list] = None,
               nodes: Optional[list] = None) -> MetaLogEntry:
        """Publish one ref: log append + fsync, journal commit + fsync,
        directory fsync when a file was created.  An existing live
        entry of the same name is superseded (its bytes go dead for
        compaction).  ``hashes``/``nodes`` are the optional index
        projection (see the module docstring) carried on the journal
        record.  Power-loss durable on return — this IS the cluster's
        write acknowledgment."""
        key = norm_name(name)
        if not key:
            raise MetaLogError(f"invalid meta-log name {name!r}")
        view = memoryview(data)
        _fsio.makedirs(self.root)
        with self._lock, _Flock(self.root):
            self._refresh_locked()
            log, offset = self._active_log_locked(len(view))
            path = self.log_path(log)
            with _fsio.open(path, "ab") as f:
                # 'ab' positions at EOF; trust the fd, not the earlier
                # stat (appends are flock-serialized, but another
                # process's store handle may have raced the rollover
                # decision)
                offset = f.tell()
                try:
                    f.write(view)
                    f.flush()
                    _fsio.fsync(f)
                except OSError:
                    # ENOSPC/EIO mid-append: truncate the partial tail
                    # away so offset accounting never packs around
                    # garbage; nothing was journaled, so the failed
                    # publish is invisible to every reader
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
            created = offset == 0
            # wall-clock publish stamp for humans and
            # the GC grace window (like the slab journal's `t` field —
            # operator forensics, never a duration; it must stay real
            # even inside a simulation)
            # lint: clock-ok wall-clock publish stamp for humans and
            # the GC grace window (like the slab journal's `t` field —
            # operator forensics, never a duration; it must stay real
            # even inside a simulation)
            published = time.time()
            gen = self._gen + 1
            record = {"o": "p", "n": key, "g": gen, "s": log,
                      "f": offset, "l": len(view), "t": published}
            if hashes is not None:
                record["h"] = list(hashes)
            if nodes is not None:
                record["nk"] = [list(pair) for pair in nodes]
            created |= self._journal_commit_locked(record)
            if created:
                # new dirent(s): without this barrier the completed
                # publish is not power-loss durable (a power cut could
                # lose the new file entirely); appends to existing
                # files are covered by the data and journal fsyncs
                _fsio.fsync_dir(self.root)
            old = self._entries.get(key)
            if old is not None and not old.tombstone:
                self._dead_bytes += old.length
            entry = MetaLogEntry(gen, log, offset, len(view),
                                 published, False,
                                 _parse_hashes(hashes),
                                 _parse_nodes(nodes))
            self._entries[key] = entry
            self._gen = gen
            return entry

    def tombstone(self, name: str) -> None:
        """Delete a ref: the entry goes dead and its log bytes are
        reclaimed by :meth:`compact`.  Raises ``FileNotFoundError``
        when there is no live entry, matching ``os.remove`` on a
        missing ref file.  Durable like a publish (a deletion is an
        acknowledgment too)."""
        key = norm_name(name)
        with self._lock, _Flock(self.root):
            self._refresh_locked()
            old = self._entries.get(key)
            if old is None or old.tombstone:
                raise FileNotFoundError(
                    f"no ref {key!r} in meta log {self.root}")
            # wall-clock deletion stamp, same contract
            # as the publish stamp above
            # lint: clock-ok wall-clock deletion stamp, same contract
            # as the publish stamp above
            stamp = time.time()
            gen = self._gen + 1
            created = self._journal_commit_locked(
                {"o": "d", "n": key, "g": gen, "t": stamp})
            if created:
                _fsio.fsync_dir(self.root)
            self._dead_bytes += old.length
            self._entries[key] = MetaLogEntry(gen, "", 0, 0, stamp, True)
            self._gen = gen

    # ---- compaction ----

    def compact(self) -> dict:
        """Reclaim dead bytes and drop tombstones: copy every live ref
        into fresh log files, atomically swap in a rewritten journal
        (data fsync'd before the rename, the store directory fsync'd
        after it), unlink the old logs.  The copy-then-publish shape
        of ``SlabStore.compact``: a crash at any point leaves a store
        that reads either entirely pre- or entirely post-compaction.
        Generations survive the swap via the journal's ``{"o": "g"}``
        floor record, so a ``changes()`` cursor never sees the counter
        run backwards.  Returns ``{"copied_bytes", "reclaimed_bytes",
        "live_refs"}``."""
        with self._lock, _Flock(self.root):
            self._refresh_locked()
            old_logs = self.log_files()
            base = (_parse_log_index(old_logs[-1]) or 0) + 1 \
                if old_logs else 1
            copied = 0
            out_log = _log_name(base)
            out_path = self.log_path(out_log)
            new_entries: dict[str, MetaLogEntry] = {}
            lines = [json.dumps({"o": "g", "g": self._gen},
                                separators=(",", ":"))]
            out = _fsio.open(out_path, "wb")
            try:
                live = sorted((n, e) for n, e in self._entries.items()
                              if not e.tombstone)
                for name, entry in live:
                    if out.tell() + entry.length > self.log_max_bytes \
                            and out.tell() > 0:
                        _fsio.fsync(out)
                        out.close()
                        base += 1
                        out_log = _log_name(base)
                        out_path = self.log_path(out_log)
                        out = _fsio.open(out_path, "wb")
                    offset = out.tell()
                    with open(self.log_path(entry.log), "rb") as src:
                        src.seek(entry.offset)
                        data = src.read(entry.length)
                    if len(data) != entry.length:
                        raise MetaLogError(
                            f"log {entry.log} truncated under live "
                            f"ref {name!r}")
                    out.write(data)
                    copied += entry.length
                    new_entries[name] = MetaLogEntry(
                        entry.generation, out_log, offset, entry.length,
                        entry.published, False,
                        entry.hashes, entry.nodes)
                    record = {"o": "p", "n": name, "g": entry.generation,
                              "s": out_log, "f": offset,
                              "l": entry.length, "t": entry.published}
                    if entry.hashes is not None:
                        record["h"] = list(entry.hashes)
                    if entry.nodes is not None:
                        record["nk"] = [list(p) for p in entry.nodes]
                    lines.append(json.dumps(record,
                                            separators=(",", ":")))
                # a failing fsync here (or on the journal temp below)
                # propagates and ABORTS the swap: the old journal stays
                # authoritative, nothing is published against bytes
                # that may never have reached the platter
                _fsio.fsync(out)
            finally:
                out.close()
            if not new_entries:
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
            # landed against the new one.  A failure raises BEFORE the
            # in-memory state flips, so the store re-reads whichever
            # journal the disk actually holds.
            _fsio.fsync_dir(self.root)
            reclaimed = self._dead_bytes
            self._entries = new_entries
            self._dead_bytes = 0
            self._journal_pos = len(payload)
            self._journal_id = os.stat(self.journal_path()).st_ino
            keep = set(e.log for e in new_entries.values())
            for log in old_logs:
                if log not in keep:
                    try:
                        _fsio.unlink(self.log_path(log))
                    except OSError:
                        pass  # held open elsewhere is fine; orphaned
            return {"copied_bytes": copied,
                    "reclaimed_bytes": reclaimed,
                    "live_refs": len(new_entries)}

    def stats(self) -> dict:
        with self._lock:
            self._refresh_locked()
            live = [e for e in self._entries.values() if not e.tombstone]
            return {
                "root": self.root,
                "live_refs": len(live),
                "live_bytes": sum(e.length for e in live),
                "dead_bytes": self._dead_bytes,
                "generation": self._gen,
                "log_files": len(self.log_files()),
            }


def is_meta_log_root(path: str) -> bool:
    """True when ``path`` is (or is being used as) a meta-log root —
    its journal exists."""
    return os.path.isfile(os.path.join(path, JOURNAL_NAME))


#: process-shared stores keyed by realpath.
# deliberately process-wide, NOT per-loop: the
# store serializes cross-thread access with its own threading.Lock and
# cross-process access with flock, and every loop/worker of a process
# must see one coherent index per root (two instances over one root
# would race their rollover decisions)
_STORES: dict[str, MetaLogStore] = {}
_STORES_LOCK = threading.Lock()


def get_store(root: str) -> MetaLogStore:
    """The process-shared :class:`MetaLogStore` for a root directory."""
    key = os.path.realpath(root)
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = _STORES[key] = MetaLogStore(root)
        return store


class MetadataLog:
    """The ``type: meta-log`` :class:`MetadataStore` kind: the
    file-per-ref contract (``write``/``read``/``list``/``to_obj``)
    over a :class:`MetaLogStore`, plus the index-powered extras
    (``namespace_snapshot``, ``changes``, ``delete``) the scrub daemon
    and GC ride.  Formats serialize exactly like ``MetadataPath`` —
    the golden ``meta_log_placement`` fixture pins refs byte-identical
    across stores."""

    def __init__(self, path: str, format=None):
        from chunky_bits_tpu_torch.cluster.metadata import MetadataFormat

        self.path = str(path)
        self.format = format or MetadataFormat()
        self.store = get_store(self.path)

    def _append(self, path: str, data: bytes, payload) -> None:
        """Off-loop half of :meth:`write`: extract the index projection
        (one ``FileReference.from_obj`` — CPU work that belongs on the
        worker thread, not the event loop) and append."""
        hashes, nodes = extract_index_meta(payload)
        self.store.append(path, data, hashes=hashes, nodes=nodes)

    async def write(self, path: str, payload) -> None:
        text = self.format.to_string(payload)
        try:
            await asyncio.to_thread(self._append, path, text.encode(),
                                    payload)
        except OSError as err:
            raise MetadataReadError(str(err)) from err

    async def read(self, path: str):
        try:
            data = await asyncio.to_thread(self.store.read_bytes, path)
        except OSError as err:
            raise MetadataReadError(str(err)) from err
        return self.format.from_bytes(data)

    async def delete(self, path: str) -> None:
        try:
            await asyncio.to_thread(self.store.tombstone, path)
        except OSError as err:
            raise MetadataReadError(str(err)) from err

    async def list(self, path: str):
        from chunky_bits_tpu_torch.cluster.metadata import FileOrDirectory

        listed = await asyncio.to_thread(self.store.list_children, path)
        if listed is None:
            raise MetadataReadError(
                str(LocationError(f"not a file or directory: {path}")))
        kind, children = listed
        key = norm_name(path)
        top = FileOrDirectory(kind, key if key else ".")
        out = [top]
        for child_kind, name in children:
            pub = f"{key}/{name}" if key else name
            out.append(FileOrDirectory(child_kind, pub))
        return out

    async def list_files_recursive(self, path: str = "") -> list[str]:
        """Every live file path under ``path`` (sorted) from ONE index
        scan — the no-dirent-walk recursive listing ("" = the whole
        namespace).  The path-store equivalent is a ``list()`` walk
        with one round-trip per directory."""
        return await asyncio.to_thread(self.store.prefix_names, path)

    async def namespace_snapshot(self) -> list[tuple[str, object]]:
        """(public path, parsed ref obj) for every live ref,
        name-sorted — one index scan plus at most one sequential read
        per log file.  THE input for a scrub/GC pass: degraded-first
        ordering, the verify walk and the liveness set all come from
        this single read instead of one metadata round-trip per object
        per consumer."""

        def _snapshot() -> list[tuple[str, object]]:
            raw = self.store.read_many(self.store.snapshot_entries())
            loads = self.format.loader()
            try:
                return [(name, loads(data)) for name, data in raw]
            except (json.JSONDecodeError, yaml.YAMLError) as err:
                raise SerdeError(str(err)) from err

        try:
            return await asyncio.to_thread(_snapshot)
        except OSError as err:
            raise MetadataReadError(str(err)) from err

    async def namespace_nodes(self) -> Optional[list]:
        """[(public path, ((kind, node), ...)), ...] for every live
        ref, name-sorted, from ONE index scan — zero ref reads, zero
        parses.  THE scrub priority pre-scan input: intersect each
        ref's node keys with ``HealthScoreboard.degraded_keys()`` to
        score the whole namespace in microseconds per thousand refs.
        None when any live entry lacks the projection (foreign payload
        or a pre-projection writer) — the caller falls back to the
        full snapshot read, so scoring is never silently partial."""

        def _scan() -> Optional[list]:
            out = []
            for name, _hashes, nodes in self.store.index_meta():
                if nodes is None:
                    return None
                out.append((name, nodes))
            return out

        return await asyncio.to_thread(_scan)

    async def namespace_hashes(self) -> Optional[list]:
        """[(public path, (hash display str, ...)), ...] for every live
        ref, name-sorted, from ONE index scan — the GC liveness walk
        with zero ref reads and zero parses.  None when any live entry
        lacks the projection (the caller falls back to the snapshot
        parse, so liveness is never silently partial — a missed live
        hash would be a deleted chunk)."""

        def _scan() -> Optional[list]:
            out = []
            for name, hashes, _nodes in self.store.index_meta():
                if hashes is None:
                    return None
                out.append((name, hashes))
            return out

        return await asyncio.to_thread(_scan)

    async def read_objs(self, names) -> list[tuple[str, object]]:
        """(public path, parsed ref obj) for ``names`` (input order;
        unknown/deleted names skipped): one batch lookup, grouped
        sequential log reads, one parse per ref — the scrub verify
        walk's paged fetch, so a pass holds one PAGE of parsed objects
        instead of the whole namespace."""

        def _read() -> list[tuple[str, object]]:
            raw = self.store.read_many(self.store.entries_for(names))
            loads = self.format.loader()
            try:
                return [(name, loads(data)) for name, data in raw]
            except (json.JSONDecodeError, yaml.YAMLError) as err:
                raise SerdeError(str(err)) from err

        try:
            return await asyncio.to_thread(_read)
        except OSError as err:
            raise MetadataReadError(str(err)) from err

    async def changes(self, since_generation: int,
                      limit: int = DEFAULT_CHANGES_LIMIT
                      ) -> list[ChangeRecord]:
        """The bounded recently-written tail (see
        :meth:`MetaLogStore.changes`)."""
        return await asyncio.to_thread(self.store.changes,
                                       since_generation, limit)

    async def generation(self) -> int:
        return await asyncio.to_thread(self.store.generation)

    async def compact(self) -> dict:
        return await asyncio.to_thread(self.store.compact)

    def to_obj(self) -> dict:
        return {"type": "meta-log", "format": self.format.name,
                "path": self.path}
