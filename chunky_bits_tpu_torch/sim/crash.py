"""The crash-consistency harness (the port of
``chunky_bits_tpu/sim/crash.py``): deterministic disk-fault injection and
recovery proof for the storage plane.

The storage-plane twin of the clock seam's scenario engine: where
``sim/scenario.py`` proves the *network/time* plane against scripted
fleet faults, this module proves the *disk* plane against every crash
point of its durability protocols.  A **mutation** (slab append +
journal commit, GC mark-dead, compaction, atomic chunk publication,
metadata publication, the repair planner's in-place rewrite) runs once
against a live directory with a :class:`RecordingFsProvider` installed
on the filesystem seam (``file/fsio.py``), capturing the exact
durability-op stream — opens with create/truncate/append flags, write
payloads, flush/fsync barriers, renames, unlinks, directory fsyncs.
The **replayer** then deterministically materializes every prefix
"crash at op k" into a cloned directory under several failure models:

* ``kill``     — process killed at op k: writes after each handle's
  last flush/fsync/close barrier die with the userspace buffer, the
  page cache (and so every flushed byte) survives.
* ``flush``    — same point, but every recorded write reached the OS
  (the buffer happened to drain): the superset-survival image.
* ``torn``     — ``flush`` with the final write cut short (1 byte and
  half-payload variants): the torn-final-write image.
* ``powercut`` — power loss: only fsync'd data is guaranteed, and the
  page cache writes back in ANY order — enumerated as per-file
  keep/drop masks over the handles with unsynced writes (the mask
  that keeps the journal line while dropping the slab bytes is
  exactly the documented ``file/slab.py`` power-loss window).
  Directory entries (renames, creates, unlinks) survive: metadata
  journaling is ordered, data writeback is not.
* ``powercut-meta`` — the other extreme: every name op after the last
  ``fsync_dir`` barrier is also lost (an un-fsync'd rename is not
  durable) along with all unsynced data.  This is the model that
  makes the directory-fsync satellite provable: a completed metadata
  publication or compaction swap must survive it, because the code
  now fsyncs the directory before returning.

After each image the **verifier** restarts the store machinery cold
(fresh ``SlabStore``, fresh ``Location``/``MetadataPath``) and asserts
the invariants the docstrings claim: pre-existing (snapshot-durable)
data always reads back byte-exact; the mutated name is absent, exact,
or — in powercut images only — present with bytes the content-address
gate DETECTS (never silently wrong); torn journal tails are ignored
and repaired by the next append; compaction leaves the old or the new
journal, never neither; acknowledged metadata publications survive
every power-cut image; the stale-temp reaper can never eat a live
store file; and the store accepts new work afterwards.
:func:`run_cluster_recovery` runs the same machinery one level up: a
real erasure-coded cluster with one destination rolled back to a crash
image, then ``scrub --once`` (the production ``ScrubDaemon`` with the
repair planner) must converge the namespace to Valid — including the
journal-line-without-slab-bytes power-loss image.

Determinism: mutations seed their payload RNG, op streams are replayed
(not re-executed), and :func:`matrix_digest` hashes the normalized op
stream plus every verdict — same seed ⇒ same crash matrix, same
verdicts (BASELINE config 16 double-runs it; wall-clock publish
stamps are excluded from the digest by construction).

Production paths import NOTHING from this module (the ``sim/``
discipline, pinned by test); it is tooling for tests, smoke runs and
scenario scripts.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import random
import re
import shutil
from dataclasses import dataclass, field
from typing import Callable, Optional

from chunky_bits_tpu_torch.utils import fsio as _fsio
from chunky_bits_tpu_torch.utils.fsio import FsOp, RecordingFsProvider

__all__ = [
    "CrashMatrixResult",
    "CrashVerdict",
    "MUTATIONS",
    "OpReplayer",
    "matrix_digest",
    "record_mutation",
    "run_cluster_recovery",
    "run_matrix",
]

#: data-barrier ops per failure model: writes after a handle's last
#: barrier are lost (powercut honors only true fsync; kill honors the
#: userspace-buffer drains too)
_KILL_BARRIERS = ("flush", "fsync", "close")
_SYNC_BARRIERS = ("fsync",)

#: cap on per-fid powercut mask enumeration: up to 3 unsynced handles
#: enumerate every subset; beyond that, all-drop / all-keep / each
#: singleton-keep (the adversarial corners) keep the matrix bounded
_MASK_EXHAUSTIVE_FIDS = 3

#: normalizers for the determinism digest: publication temps and
#: compaction temps embed pid/random hex that vary run to run while
#: naming the same logical op
_NORM_RES = (
    (re.compile(r"\.tmp\.\d+\.[0-9a-f]{8}"), ".tmp.<pid>.<rand>"),
    (re.compile(r"\.compact\.\d+"), ".compact.<pid>"),
)


def _norm_path(path: str) -> str:
    for pattern, repl in _NORM_RES:
        path = pattern.sub(repl, path)
    return path


def record_mutation(root: str, fn: Callable[[], None]) -> list[FsOp]:
    """Run ``fn`` with a :class:`RecordingFsProvider` rooted at
    ``root`` installed on the seam; returns the captured op stream.
    Ops outside ``root`` pass through unrecorded (one failure domain
    per recording)."""
    provider = RecordingFsProvider(root)
    previous = _fsio.install(provider)
    try:
        fn()
    finally:
        _fsio.install(previous)
    return list(provider.ops)


# ---- the replayer: op stream -> crash image ----

class OpReplayer:
    """Materializes crash images from a snapshot directory plus a
    recorded op stream.  The virtual filesystem is inode-accurate:
    writes bind to the handle (fid) they were issued on, so a write
    that raced a dropped rename lands on the orphaned inode — absent
    from the image — exactly as on a real disk, never blended into
    whatever file the name points at afterwards."""

    def __init__(self, snapshot: str) -> None:
        self.snapshot = os.path.abspath(snapshot)
        #: rel path -> initial bytes (inode identity starts per-name)
        self._initial: dict[str, bytes] = {}
        self._initial_dirs: list[str] = []
        for dirpath, dirnames, filenames in os.walk(self.snapshot):
            rel_dir = os.path.relpath(dirpath, self.snapshot)
            if rel_dir != ".":
                self._initial_dirs.append(rel_dir.replace(os.sep, "/"))
            for name in filenames:
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, self.snapshot)
                with open(full, "rb") as f:
                    self._initial[rel.replace(os.sep, "/")] = f.read()

    # -- survival analysis --

    @staticmethod
    def _data_barriers(ops: list[FsOp], k: int,
                       barriers: tuple[str, ...]) -> dict[int, int]:
        """fid -> index of its LAST surviving data barrier before k
        (writes after it are lost in barrier-honoring modes)."""
        last: dict[int, int] = {}
        for i in range(k):
            op = ops[i]
            if op.op in barriers and op.fid >= 0:
                last[op.fid] = i
        return last

    @staticmethod
    def _unsynced_fids(ops: list[FsOp], k: int) -> list[int]:
        """Handles with at least one write after their last fsync —
        the powercut mask domain, in first-write order."""
        last_sync = OpReplayer._data_barriers(ops, k, _SYNC_BARRIERS)
        seen: list[int] = []
        for i in range(k):
            op = ops[i]
            if op.op == "write" and i > last_sync.get(op.fid, -1) \
                    and op.fid not in seen:
                seen.append(op.fid)
        return seen

    def variants(self, ops: list[FsOp], k: int
                 ) -> list[tuple[str, str, dict]]:
        """Every (mode, variant-id, params) image to build for a crash
        before op ``k`` — the deterministic enumeration config 16
        reports as its crash-point count."""
        out: list[tuple[str, str, dict]] = [
            ("kill", "", {}),
            ("flush", "", {}),
            ("powercut-meta", "", {}),
        ]
        if k > 0 and ops[k - 1].op == "write" \
                and len(ops[k - 1].data) >= 2:
            out.append(("torn", "1", {"torn": 1}))
            out.append(("torn", "half",
                        {"torn": len(ops[k - 1].data) // 2}))
        fids = self._unsynced_fids(ops, k)
        if len(fids) <= _MASK_EXHAUSTIVE_FIDS:
            masks = range(1 << len(fids))
        else:
            masks = [0, (1 << len(fids)) - 1] \
                + [1 << i for i in range(len(fids))]
        for mask in masks:
            keep = frozenset(f for i, f in enumerate(fids)
                             if mask & (1 << i))
            out.append(("powercut", f"m{mask}", {"keep": keep}))
        return out

    def build(self, ops: list[FsOp], k: int, mode: str, dest: str,
              torn: Optional[int] = None,
              keep: frozenset = frozenset()) -> None:
        """Materialize the crash image for ops[0:k] under ``mode``
        into ``dest`` (created fresh)."""
        if mode in ("flush", "torn"):
            def write_survives(i: int, op: FsOp) -> bool:
                return True
        elif mode == "kill":
            last = self._data_barriers(ops, k, _KILL_BARRIERS)

            def write_survives(i: int, op: FsOp) -> bool:
                return i <= last.get(op.fid, -1) or self._barrier_after(
                    ops, k, i, op.fid, _KILL_BARRIERS)
        else:  # powercut / powercut-meta
            def write_survives(i: int, op: FsOp) -> bool:
                if self._barrier_after(ops, k, i, op.fid,
                                       _SYNC_BARRIERS):
                    return True
                return (mode == "powercut" and op.fid in keep)
        if mode == "powercut-meta":
            last_dir_sync = -1
            for i in range(k):
                if ops[i].op == "fsync_dir":
                    last_dir_sync = i

            def name_survives(i: int) -> bool:
                return i <= last_dir_sync
        else:
            def name_survives(i: int) -> bool:
                return True

        # virtual fs: fid -> content; name -> fid; created dirs
        files: dict[int, bytearray] = {}
        names: dict[str, int] = {}
        dirs: list[str] = list(self._initial_dirs)
        next_fid = [10 ** 9]  # snapshot inode ids live above recorded
        for rel, data in self._initial.items():
            fid = next_fid[0]
            next_fid[0] += 1
            files[fid] = bytearray(data)
            names[rel] = fid
        fidmap: dict[int, int] = {}

        for i in range(k):
            op = ops[i]
            if op.op == "open":
                existing = names.get(op.path)
                if existing is not None and "t" not in op.aux:
                    fidmap[op.fid] = existing  # same inode, append/rw
                elif existing is not None and "t" in op.aux:
                    # O_TRUNC keeps the inode; the size change is
                    # metadata-journaled — honor name-survival
                    fidmap[op.fid] = existing
                    if name_survives(i):
                        files[existing] = bytearray()
                else:
                    # creation: the dirent is a name op, the inode is
                    # real either way — writes land on it, but a
                    # dropped dirent orphans the whole file
                    fidmap[op.fid] = op.fid
                    files[op.fid] = bytearray()
                    if name_survives(i):
                        names[op.path] = op.fid
            elif op.op == "write":
                fid = fidmap.get(op.fid, op.fid)
                if fid not in files:
                    files[fid] = bytearray()
                if write_survives(i, op):
                    data = op.data
                    if mode == "torn" and i == k - 1 \
                            and torn is not None:
                        data = data[:torn]
                    files[fid].extend(data)
            elif op.op == "replace":
                if name_survives(i):
                    src_fid = names.pop(op.aux, None)
                    if src_fid is not None:
                        names[op.path] = src_fid
            elif op.op == "unlink":
                if name_survives(i):
                    names.pop(op.path, None)
            elif op.op == "mkdir":
                if name_survives(i):
                    dirs.append(op.path)
            elif op.op == "truncate":
                # os.truncate by path: an i-size metadata op
                if name_survives(i):
                    fid = names.get(op.path)
                    if fid is not None:
                        del files[fid][int(op.aux):]
            # flush/fsync/close/fsync_dir: barriers, handled above

        os.makedirs(dest, exist_ok=True)
        for rel in dirs:
            os.makedirs(os.path.join(dest, rel), exist_ok=True)
        for rel, fid in names.items():
            full = os.path.join(dest, rel)
            os.makedirs(os.path.dirname(full) or dest, exist_ok=True)
            with open(full, "wb") as f:
                f.write(files.get(fid, bytearray()))

    @staticmethod
    def _barrier_after(ops: list[FsOp], k: int, i: int, fid: int,
                       barriers: tuple[str, ...]) -> bool:
        """True when a barrier for ``fid`` lands in (i, k) — the write
        at i was made durable by a LATER surviving barrier."""
        for j in range(i + 1, k):
            if ops[j].op in barriers and ops[j].fid == fid:
                return True
        return False


# ---- verdicts / matrix plumbing ----

@dataclass
class CrashVerdict:
    """One crash image's verification outcome."""

    mutation: str
    mode: str
    k: int
    variant: str
    ok: bool
    violations: list[str] = field(default_factory=list)

    def to_obj(self) -> dict:
        return {
            "mutation": self.mutation, "mode": self.mode, "k": self.k,
            "variant": self.variant, "ok": self.ok,
            **({"violations": self.violations[:4]}
               if self.violations else {}),
        }


@dataclass
class CrashMatrixResult:
    """The full matrix run: config 16's row source and the
    determinism comparison unit."""

    verdicts: list[CrashVerdict]
    ops_by_mutation: dict[str, int]
    digest: str

    def ok(self) -> bool:
        return bool(self.verdicts) and all(v.ok for v in self.verdicts)

    def failed(self) -> list[CrashVerdict]:
        return [v for v in self.verdicts if not v.ok]

    def crash_points(self) -> int:
        return sum(n + 1 for n in self.ops_by_mutation.values())

    def rows(self) -> list[dict]:
        by_mut: dict[str, dict] = {}
        for v in self.verdicts:
            row = by_mut.setdefault(v.mutation, {
                "mutation": v.mutation, "images": 0, "images_ok": 0,
                "ops": self.ops_by_mutation.get(v.mutation, 0)})
            row["images"] += 1
            row["images_ok"] += int(v.ok)
        return [by_mut[name] for name in sorted(by_mut)]


def matrix_digest(ops_streams: dict[str, list[FsOp]],
                  verdicts: list[CrashVerdict]) -> str:
    """Canonical digest of the crash matrix: normalized op stream
    shape (kinds + paths, never payload bytes — journal lines embed
    wall-clock publish stamps) plus every verdict tuple.  Equal across
    same-seed runs; the determinism double-run pins it."""
    h = hashlib.sha256()
    for name in sorted(ops_streams):
        for i, op in enumerate(ops_streams[name]):
            h.update(json.dumps(
                [name, i, op.op, _norm_path(op.path),
                 _norm_path(op.aux) if op.op == "replace" else ""],
                separators=(",", ":")).encode())
    for v in verdicts:
        h.update(json.dumps(
            [v.mutation, v.mode, v.k, v.variant, v.ok],
            separators=(",", ":")).encode())
    return h.hexdigest()


# ---- the mutation library ----

def _digest_name(payload: bytes) -> str:
    """Content-addressed chunk name: the gate every read verifies."""
    return hashlib.sha256(payload).hexdigest()


def _fresh_store(root: str):
    """A COLD SlabStore over ``root`` — deliberately not
    ``slab.get_store`` (whose process cache would hand back a warm
    index and defeat the restart-from-disk contract under test)."""
    from chunky_bits_tpu_torch.file.slab import SlabStore

    return SlabStore(root)


@dataclass(frozen=True)
class Mutation:
    """One recorded storage-plane mutation plus its recovery oracle.

    ``setup(root, rng)`` builds the durable pre-state and returns the
    oracle state; ``run(root, state)`` performs the mutation (recorded
    through the seam); ``verify(image, state, mode, k, complete)``
    returns invariant violations for one crash image (empty = clean).
    """

    name: str
    setup: Callable[[str, random.Random], dict]
    run: Callable[[str, dict], None]
    verify: Callable[[str, dict, str, int, bool], list[str]]


def _reap_temps(image: str) -> None:
    """Simulate the GC's stale-temp reaper over a crash image: every
    ``is_publish_temp`` basename goes — live store files must never
    match it (verified by re-reading afterwards)."""
    from chunky_bits_tpu_torch.file.location import is_publish_temp

    for dirpath, _dirnames, filenames in os.walk(image):
        for fname in filenames:
            if is_publish_temp(fname):
                os.unlink(os.path.join(dirpath, fname))


def _verify_slab_image(image: str, expected: dict[str, bytes],
                       pending: Optional[tuple[str, bytes]],
                       removed: Optional[str],
                       mode: str, complete: bool) -> list[str]:
    """The shared slab-store oracle.  ``expected``: chunks durable
    before the recording (must always read exact).  ``pending``: the
    chunk the mutation was publishing (absent | exact | detectably
    damaged in powercut images).  ``removed``: the chunk the mutation
    was deleting (exact | absent)."""
    violations: list[str] = []
    try:
        store = _fresh_store(image)
        live = dict(store.live_extents())
    except Exception as err:  # noqa: BLE001 — ANY cold-load crash is
        # itself the invariant violation being hunted
        return [f"cold index load failed: {type(err).__name__}: {err}"]

    def read(name: str) -> bytes:
        try:
            return store.pread(name)
        except OSError:
            return b""

    for name, payload in expected.items():
        if removed is not None and name == removed:
            continue
        if name not in live:
            violations.append(f"durable chunk {name[:8]} lost")
        elif read(name) != payload:
            violations.append(f"durable chunk {name[:8]} wrong bytes")
    if removed is not None:
        if removed in live and read(removed) != expected[removed]:
            violations.append("half-deleted chunk serves wrong bytes")
        if complete and mode in ("kill", "flush", "torn") \
                and removed in live:
            violations.append("completed delete not visible after "
                              "process crash")
    if pending is not None:
        name, payload = pending
        if name in live:
            got = read(name)
            if got != payload:
                # wrong bytes may surface ONLY where unsynced pages
                # can vanish, and must be DETECTABLE (content address)
                if mode not in ("powercut", "powercut-meta"):
                    violations.append(
                        "published chunk torn outside powercut "
                        f"(mode={mode})")
                elif _digest_name(got) == name:
                    violations.append("content-address gate blind to "
                                      "damaged chunk")
        if complete and mode in ("kill", "flush", "torn") \
                and name not in live:
            violations.append("acknowledged append invisible after "
                              "process crash")
    extras = set(live) - set(expected) \
        - ({pending[0]} if pending else set())
    if extras:
        violations.append(f"phantom extents {sorted(extras)[:2]}")

    # the GC reaper must never eat a live store file
    _reap_temps(image)
    after_reap = _fresh_store(image)
    for name, payload in expected.items():
        if removed is not None and name == removed:
            continue
        if name in live:
            try:
                if after_reap.pread(name) != payload:
                    violations.append("stale-temp reap damaged a live "
                                      "extent")
                    break
            except OSError:
                violations.append("stale-temp reap removed a live "
                                  "extent")
                break

    # forward progress: the next append must terminate any torn
    # journal tail and serve its bytes back
    recovery_payload = b"recovery-" + os.urandom(8)
    recovery_name = _digest_name(recovery_payload)
    try:
        after_reap.append(recovery_name, recovery_payload)
    except Exception as err:  # noqa: BLE001 — ANY recovery-append
        # failure on a crash image is the finding
        violations.append(f"recovery append failed: "
                          f"{type(err).__name__}: {err}")
        return violations
    reloaded = _fresh_store(image)
    if reloaded.pread(recovery_name) != recovery_payload:
        violations.append("recovery append unreadable after reload")
    for name, payload in expected.items():
        if removed is not None and name == removed:
            continue
        if name in live and reloaded.pread(name) != payload:
            violations.append("recovery append disturbed a durable "
                              "chunk")
            break
    return violations


# -- slab append --

def _setup_slab(root: str, rng: random.Random) -> dict:
    store = _fresh_store(root)
    expected: dict[str, bytes] = {}
    for _ in range(3):
        payload = rng.randbytes(rng.randrange(200, 1500))
        name = _digest_name(payload)
        store.append(name, payload)
        expected[name] = payload
    # a dead extent gives compaction real work
    doomed = rng.randbytes(300)
    store.append(_digest_name(doomed), doomed)
    store.mark_dead(_digest_name(doomed))
    new_payload = rng.randbytes(900)
    return {"expected": expected,
            "victim": sorted(expected)[0],
            "new": (_digest_name(new_payload), new_payload)}


def _run_slab_append(root: str, state: dict) -> None:
    name, payload = state["new"]
    _fresh_store(root).append(name, payload)


def _verify_slab_append(image: str, state: dict, mode: str, k: int,
                        complete: bool) -> list[str]:
    return _verify_slab_image(image, state["expected"], state["new"],
                              None, mode, complete)


# -- slab mark-dead --

def _run_slab_mark_dead(root: str, state: dict) -> None:
    _fresh_store(root).mark_dead(state["victim"])


def _verify_slab_mark_dead(image: str, state: dict, mode: str, k: int,
                           complete: bool) -> list[str]:
    return _verify_slab_image(image, state["expected"], None,
                              state["victim"], mode, complete)


# -- slab compaction --

def _run_slab_compact(root: str, state: dict) -> None:
    _fresh_store(root).compact()


def _verify_slab_compact(image: str, state: dict, mode: str, k: int,
                         complete: bool) -> list[str]:
    violations = _verify_slab_image(image, state["expected"], None,
                                    None, mode, complete)
    # old journal or new journal, never neither: the shared oracle
    # already proved every durable chunk readable; here pin that the
    # journal FILE survived every image (a missing journal is an empty
    # store — "neither")
    if not os.path.isfile(os.path.join(image, "index.jsonl")):
        violations.append("compaction crash left no journal at all")
    # a completed compaction is an acknowledged swap: after the
    # directory fsync it must also survive both power-cut models with
    # the dead extent actually reclaimed from the index
    if complete:
        store = _fresh_store(image)
        if store.dead_bytes() != 0:
            violations.append("completed compaction rolled back "
                              f"(mode={mode}: dead bytes resurfaced)")
    return violations


# -- atomic chunk publication (the writer's shard landing) --

def _setup_publish(root: str, rng: random.Random) -> dict:
    os.makedirs(root, exist_ok=True)
    payload = rng.randbytes(1100)
    return {"target": "chunk", "old": None,
            "new": (_digest_name(payload), payload)}


def _run_publish(root: str, state: dict) -> None:
    from chunky_bits_tpu_torch.file.location import Location

    _name, payload = state["new"]
    target = os.path.join(root, state["target"])
    asyncio.run(Location.parse(target).write(payload))


def _verify_publish(image: str, state: dict, mode: str, k: int,
                    complete: bool) -> list[str]:
    violations: list[str] = []
    name, payload = state["new"]
    old: Optional[bytes] = state["old"]
    target = os.path.join(image, state["target"])
    if os.path.exists(target):
        with open(target, "rb") as f:
            got = f.read()
        allowed = [payload] + ([old] if old is not None else [])
        if got not in allowed:
            if mode not in ("powercut", "powercut-meta"):
                violations.append(
                    f"published path torn outside powercut "
                    f"(mode={mode}, {len(got)}b)")
            elif _digest_name(got) == name:
                violations.append("content-address gate blind to "
                                  "damaged publication")
    elif old is not None:
        violations.append("pre-existing target vanished")
    elif complete and mode in ("kill", "flush", "torn"):
        violations.append("acknowledged publication invisible after "
                          "process crash")
    # crashed-writer temps must be reapable without touching the target
    _reap_temps(image)
    remaining = [f for f in os.listdir(image)]
    if state["target"] in remaining:
        with open(target, "rb") as f:
            after = f.read()
        allowed = [payload] + ([old] if old is not None else [])
        if after not in allowed \
                and mode not in ("powercut", "powercut-meta"):
            violations.append("temp reap disturbed the published path")
    stray = [f for f in remaining
             if f != state["target"] and not f.startswith(".")]
    if stray:
        violations.append(f"unreapable leftovers {stray[:2]}")
    return violations


# -- repair planner in-place rewrite --

def _setup_repair(root: str, rng: random.Random) -> dict:
    os.makedirs(root, exist_ok=True)
    payload = rng.randbytes(1100)
    corrupt = bytearray(payload)
    corrupt[rng.randrange(len(corrupt))] ^= 0x5A
    with open(os.path.join(root, "chunk"), "wb") as f:
        f.write(bytes(corrupt))
    return {"target": "chunk", "old": bytes(corrupt),
            "new": (_digest_name(payload), payload)}


def _run_repair_rewrite(root: str, state: dict) -> None:
    from chunky_bits_tpu_torch.file.location import (
        OVERWRITE,
        Location,
        default_context,
    )

    _name, payload = state["new"]
    target = os.path.join(root, state["target"])
    # exactly the planner's write shape (cluster/repair.py
    # _write_victims): a content-verified payload overwriting the
    # victim in place through the atomic-publication protocol
    cx = default_context().but_with(on_conflict=OVERWRITE)
    asyncio.run(Location.parse(target).write(payload, cx))


# -- metadata publication --

def _setup_metadata(root: str, rng: random.Random) -> dict:
    from chunky_bits_tpu_torch.cluster.metadata import MetadataPath

    os.makedirs(root, exist_ok=True)
    old = {"length": 1, "parts": [rng.randrange(1 << 30)]}
    asyncio.run(MetadataPath(root, None).write("obj", old))
    new = {"length": 2, "parts": [rng.randrange(1 << 30),
                                  rng.randrange(1 << 30)]}
    return {"target": "obj", "old": old, "new": new}


def _run_metadata(root: str, state: dict) -> None:
    from chunky_bits_tpu_torch.cluster.metadata import MetadataPath

    asyncio.run(MetadataPath(root, None).write(state["target"],
                                               state["new"]))


def _verify_metadata(image: str, state: dict, mode: str, k: int,
                     complete: bool) -> list[str]:
    from chunky_bits_tpu_torch.cluster.metadata import MetadataPath

    violations: list[str] = []
    meta = MetadataPath(image, None)

    def parsed() -> Optional[dict]:
        try:
            return asyncio.run(meta.read(state["target"]))
        except Exception:  # noqa: BLE001 — unparseable/absent is the
            # classification being tested, not an oracle failure
            return None

    got = parsed()
    if got not in (state["old"], state["new"]):
        violations.append(
            "metadata neither old nor new "
            f"({'unreadable' if got is None else 'foreign'})")
    # the acknowledged-write durability pin (the dir-fsync satellite):
    # a COMPLETED metadata publication survives every failure model,
    # including both power-cut extremes
    if complete and got != state["new"]:
        violations.append(
            f"acknowledged metadata publication lost (mode={mode})")
    # crashed-writer temps: the next write must reap them
    for fname in os.listdir(image):
        full = os.path.join(image, fname)
        if fname != state["target"]:
            os.utime(full, (1.0, 1.0))  # age past STALE_TEMP_SECONDS
    _run_metadata(image, state)
    from chunky_bits_tpu_torch.file.location import is_publish_temp

    leaked = [f for f in os.listdir(image) if is_publish_temp(f)]
    if leaked:
        violations.append(f"stale temps not reaped on next write: "
                          f"{leaked[:2]}")
    if parsed() != state["new"]:
        violations.append("recovery write unreadable")
    return violations


# -- meta-log publication / compaction (cluster/meta_log.py) --

def _fresh_meta_store(root: str):
    """A COLD MetaLogStore over ``root`` — deliberately not
    ``meta_log.get_store`` (same rationale as ``_fresh_store``: the
    process cache would hand back a warm index and defeat the
    restart-from-disk contract under test)."""
    from chunky_bits_tpu_torch.cluster.meta_log import MetaLogStore

    return MetaLogStore(root)


def _verify_meta_log_image(image: str, expected: dict[str, bytes],
                           pending: Optional[tuple[str, bytes]],
                           mode: str, complete: bool) -> list[str]:
    """The shared meta-log oracle — STRONGER than the slab oracle on
    the pending entry: a meta-log publish is the cluster's write
    acknowledgment (ref bytes fsync'd, then the journal line fsync'd,
    then a directory fsync when a file was created), so a COMPLETED
    append must survive EVERY failure model, both power-cut extremes
    included — and a ref the index serves at all must serve exact
    bytes in every mode (the journal line only ever lands after its
    ref bytes are on the platter, and torn journal lines are never
    applied)."""
    violations: list[str] = []
    try:
        store = _fresh_meta_store(image)
        names = set(store.live_names())
    except Exception as err:  # noqa: BLE001 — ANY cold-load crash is
        # itself the invariant violation being hunted
        return [f"cold index load failed: {type(err).__name__}: {err}"]

    def read(name: str) -> bytes:
        try:
            return store.read_bytes(name)
        except OSError:
            return b""

    for name, payload in expected.items():
        if name not in names:
            violations.append(f"durable ref {name!r} lost (mode={mode})")
        elif read(name) != payload:
            violations.append(f"durable ref {name!r} wrong bytes")
    if pending is not None:
        name, payload = pending
        if name in names and read(name) != payload:
            violations.append(
                f"indexed ref {name!r} serves wrong bytes (mode={mode}:"
                " journal committed before its data was durable)")
        if complete and name not in names:
            violations.append(
                f"acked metadata publish lost (mode={mode})")
    extras = names - set(expected) \
        - ({pending[0]} if pending else set())
    if extras:
        violations.append(f"phantom refs {sorted(extras)[:2]}")

    # forward progress: the next publish must terminate any torn
    # journal tail and serve its bytes back
    recovery_payload = b"recovery-" + os.urandom(8)
    try:
        store.append("recovery-obj", recovery_payload)
    except Exception as err:  # noqa: BLE001 — ANY recovery-append
        # failure on a crash image is the finding
        violations.append(f"recovery publish failed: "
                          f"{type(err).__name__}: {err}")
        return violations
    reloaded = _fresh_meta_store(image)
    try:
        if reloaded.read_bytes("recovery-obj") != recovery_payload:
            violations.append("recovery publish unreadable after "
                              "reload")
    except OSError:
        violations.append("recovery publish invisible after reload")
    for name, payload in expected.items():
        if name in names:
            try:
                if reloaded.read_bytes(name) != payload:
                    violations.append("recovery publish disturbed a "
                                      "durable ref")
                    break
            except OSError:
                violations.append("recovery publish lost a durable ref")
                break
    return violations


def _proj_of(name: str) -> tuple[list, list]:
    """Deterministic index projection (hashes, node keys) for a setup
    ref — publish records in the matrix carry the projection fields so
    every crash point of the LONGER journal line (and compaction's
    projection copy) is replayed too."""
    digest = "sha256-" + name.encode().hex().ljust(64, "0")[:64]
    return [digest], [["local", f"/nodes/{name.split('/')[-1]}"]]


def _setup_meta_log(root: str, rng: random.Random) -> dict:
    store = _fresh_meta_store(root)
    expected: dict[str, bytes] = {}
    for i in range(3):
        payload = rng.randbytes(rng.randrange(100, 900))
        name = f"dir/obj-{i}"
        hashes, nodes = _proj_of(name)
        store.append(name, payload, hashes=hashes, nodes=nodes)
        expected[name] = payload
    # a tombstone gives compaction real work (dead bytes + a dropped
    # record) and pins that replays keep it dead
    doomed = rng.randbytes(300)
    store.append("dir/doomed", doomed)
    store.tombstone("dir/doomed")
    new_payload = rng.randbytes(700)
    return {"expected": expected, "gen": store.generation(),
            "new": ("dir/obj-new", new_payload)}


def _run_meta_log_append(root: str, state: dict) -> None:
    name, payload = state["new"]
    hashes, nodes = _proj_of(name)
    _fresh_meta_store(root).append(name, payload,
                                   hashes=hashes, nodes=nodes)


def _verify_meta_log_append(image: str, state: dict, mode: str, k: int,
                            complete: bool) -> list[str]:
    return _verify_meta_log_image(image, state["expected"],
                                  state["new"], mode, complete)


def _run_meta_log_compact(root: str, state: dict) -> None:
    _fresh_meta_store(root).compact()


def _verify_meta_log_compact(image: str, state: dict, mode: str, k: int,
                             complete: bool) -> list[str]:
    violations = _verify_meta_log_image(image, state["expected"], None,
                                        mode, complete)
    # old journal or new journal, never neither: the shared oracle
    # already proved every durable ref readable; pin that the journal
    # FILE survived every image (a missing journal is an empty store)
    from chunky_bits_tpu_torch.cluster import meta_log as _ml

    if not os.path.isfile(os.path.join(image, _ml.JOURNAL_NAME)):
        violations.append("compaction crash left no journal at all")
    if complete:
        store = _fresh_meta_store(image)
        # a completed compaction is an acknowledged swap (tmp fsync +
        # rename + dir fsync): the reclaim must survive both power-cut
        # extremes...
        if store.dead_bytes() != 0:
            violations.append("completed compaction rolled back "
                              f"(mode={mode}: dead bytes resurfaced)")
        # ...and so must the generation floor record — a counter that
        # ran backwards would hand re-used generations to changes()
        # cursors
        if store.generation() < state["gen"]:
            violations.append(
                f"generation ran backwards across compaction "
                f"({store.generation()} < {state['gen']}, mode={mode})")
        # ...and so must the index projections (scrub pre-scan / GC
        # fast paths): a compaction that dropped them would silently
        # demote every consumer to the fallback read forever
        for name in state["expected"]:
            entry = store.lookup(name)
            hashes, nodes = _proj_of(name)
            if entry is not None and (
                    entry.hashes != tuple(hashes)
                    or entry.nodes != tuple(
                        tuple(p) for p in nodes)):
                violations.append(
                    f"index projection lost across compaction "
                    f"({name!r}, mode={mode})")
                break
    return violations


MUTATIONS: dict[str, Mutation] = {
    m.name: m for m in (
        Mutation("slab_append", _setup_slab, _run_slab_append,
                 _verify_slab_append),
        Mutation("slab_mark_dead", _setup_slab, _run_slab_mark_dead,
                 _verify_slab_mark_dead),
        Mutation("slab_compact", _setup_slab, _run_slab_compact,
                 _verify_slab_compact),
        Mutation("chunk_publish", _setup_publish, _run_publish,
                 _verify_publish),
        Mutation("repair_rewrite", _setup_repair, _run_repair_rewrite,
                 _verify_publish),
        Mutation("metadata_publish", _setup_metadata, _run_metadata,
                 _verify_metadata),
        Mutation("meta_log_append", _setup_meta_log,
                 _run_meta_log_append, _verify_meta_log_append),
        Mutation("meta_log_compact", _setup_meta_log,
                 _run_meta_log_compact, _verify_meta_log_compact),
    )
}


def run_matrix(workdir: str, *, seed: int = 0,
               mutations: Optional[list[str]] = None
               ) -> CrashMatrixResult:
    """Enumerate and verify the full crash matrix for the selected
    mutations under ``workdir``.  Deterministic: same seed ⇒ same op
    streams (shape), same images, same verdicts, same digest."""
    names = sorted(mutations) if mutations is not None \
        else sorted(MUTATIONS)
    unknown = [n for n in names if n not in MUTATIONS]
    if unknown:
        raise ValueError(f"unknown mutation(s) {unknown} "
                         f"(know {sorted(MUTATIONS)})")
    verdicts: list[CrashVerdict] = []
    streams: dict[str, list[FsOp]] = {}
    for name in names:
        mutation = MUTATIONS[name]
        rng = random.Random(seed * 7_919 + len(name))
        base = os.path.join(workdir, name, "base")
        snap = os.path.join(workdir, name, "snap")
        shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)
        os.makedirs(base)
        state = mutation.setup(base, rng)
        shutil.copytree(base, snap, dirs_exist_ok=True)
        ops = record_mutation(base, lambda: mutation.run(base, state))
        if not ops:
            raise AssertionError(
                f"mutation {name} recorded no durability ops — the "
                "seam is not wired through its write path")
        streams[name] = ops
        replayer = OpReplayer(snap)
        image_root = os.path.join(workdir, name, "img")
        for k in range(len(ops) + 1):
            complete = k == len(ops)
            for mode, variant, params in replayer.variants(ops, k):
                shutil.rmtree(image_root, ignore_errors=True)
                replayer.build(ops, k, mode, image_root,
                               torn=params.get("torn"),
                               keep=params.get("keep", frozenset()))
                violations = mutation.verify(image_root, state, mode,
                                             k, complete)
                verdicts.append(CrashVerdict(
                    name, mode, k, variant, not violations,
                    violations))
        shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)
    return CrashMatrixResult(
        verdicts=verdicts,
        ops_by_mutation={n: len(s) for n, s in streams.items()},
        digest=matrix_digest(streams, verdicts))


# ---- cluster-level recovery: crash image + scrub --once -> Valid ----

def run_cluster_recovery(workdir: str, *, seed: int = 0,
                         points: str = "full") -> list[CrashVerdict]:
    """The end-to-end case: a real erasure-coded cluster (five
    ``slab:`` destinations, path metadata) ingests an object while ONE
    destination records; every selected crash image of that
    destination — including the journal-line-without-slab-bytes
    power-cut image — is spliced back under a COLD cluster, and
    ``scrub --once`` (the production daemon + repair planner) must
    converge both objects to Valid with byte-identical reads.

    ``points``: ``"smoke"`` verifies the completed-mutation power-cut
    images only; ``"full"`` adds the start/middle kill images."""
    # the write path's jitter draws ride the process-global RNG; the
    # impl pins it so op streams replay identically run to run —
    # bracket the pin here so the caller's stream is restored whatever
    # happens (scenario.py's bracketing discipline)
    previous_random_state = random.getstate()
    try:
        return _cluster_recovery_impl(workdir, seed=seed, points=points)
    finally:
        random.setstate(previous_random_state)


def _cluster_recovery_impl(workdir: str, *, seed: int,
                           points: str) -> list[CrashVerdict]:
    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.file import FileIntegrity
    from chunky_bits_tpu_torch.utils import aio

    workdir = os.path.abspath(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    rng = random.Random(seed + 17)
    random.seed(seed * 2_654_435_761 + 131)

    def cluster_obj(root: str) -> dict:
        return {
            "destinations": [
                {"location": f"slab:{os.path.join(root, f'd{i}')}"}
                for i in range(5)],
            "metadata": {"type": "path", "format": "yaml",
                         "path": os.path.join(root, "meta")},
            "profiles": {"default": {"data": 3, "parity": 2,
                                     "chunk_size": 12}},
        }

    base = os.path.join(workdir, "base")
    os.makedirs(base)
    payloads = {"obj1": rng.randbytes(8 << 10),
                "obj2": rng.randbytes(8 << 10)}

    async def write_one(root: str, name: str) -> None:
        cluster = Cluster.from_obj(cluster_obj(root))
        try:
            await cluster.write_file(
                name, aio.BytesReader(payloads[name]),
                cluster.get_profile())
        finally:
            await cluster.tunables.location_context().aclose()

    asyncio.run(write_one(base, "obj1"))  # durable pre-state
    d0 = os.path.join(base, "d0")
    snap_d0 = os.path.join(workdir, "snap_d0")
    shutil.copytree(d0, snap_d0)
    ops = record_mutation(
        d0, lambda: asyncio.run(write_one(base, "obj2")))
    if not ops:
        raise AssertionError("object ingest recorded no ops on d0")
    # chunk locations in the metadata are absolute paths, so every
    # crash image is spliced back AT ``base`` (a copied tree would
    # leave the refs pointing at the pristine original — a vacuously
    # green verifier); ``final`` preserves the post-ingest state each
    # image restarts from
    final = os.path.join(workdir, "final")
    shutil.copytree(base, final)
    replayer = OpReplayer(snap_d0)
    n = len(ops)
    if points == "smoke":
        selected: list[tuple[int, str]] = [(n, "powercut")]
    else:
        selected = [(0, "kill"), (n // 2, "kill"), (n, "kill"),
                    (n // 2, "powercut"), (n, "powercut"),
                    (n, "powercut-meta")]

    async def scrub_and_verify(root: str) -> list[str]:
        from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon

        violations: list[str] = []
        cluster = Cluster.from_obj(cluster_obj(root))
        try:
            daemon = ScrubDaemon(cluster, bytes_per_sec=0,
                                 interval_seconds=3600.0, planner=True)
            await daemon.run_once()
            for name, payload in sorted(payloads.items()):
                try:
                    ref = await cluster.get_file_ref(name)
                except Exception as err:  # noqa: BLE001 — a lost ref
                    # IS the verdict for the image under test
                    if name == "obj2":
                        continue  # ingest never acknowledged: clean
                        # not-found is a legal (and detectable) outcome
                    violations.append(f"{name} ref unreadable: {err}")
                    continue
                report = await ref.verify()
                if report.integrity() != FileIntegrity.VALID:
                    violations.append(
                        f"{name} not Valid after scrub --once: "
                        f"{report.integrity()}")
                got = await cluster.file_read_builder(ref).read_all()
                if got != payload:
                    violations.append(f"{name} bytes diverged after "
                                      "recovery")
        finally:
            await cluster.tunables.location_context().aclose()
        return violations

    verdicts: list[CrashVerdict] = []
    for k, mode in selected:
        # the powercut mask that keeps the journal handle but drops
        # the slab-data handle is the documented flush-only window;
        # enumerate every mask at this k and test the worst ones
        variants = [(m, v, p) for m, v, p in replayer.variants(ops, k)
                    if m == mode] or [(mode, "", {})]
        for mode_name, variant, params in variants:
            shutil.rmtree(base)
            shutil.copytree(final, base)
            shutil.rmtree(d0)
            replayer.build(ops, k, mode_name, d0,
                           torn=params.get("torn"),
                           keep=params.get("keep", frozenset()))
            violations = asyncio.run(scrub_and_verify(base))
            verdicts.append(CrashVerdict(
                "cluster_scrub_recovery", mode_name, k, variant,
                not violations, violations))
    return verdicts
