"""Scheduled-XOR lowering of GF(2^8) coding matrices (the port of
``chunky_bits_tpu/ops/xor_schedule.py``).

Lowers an r x k byte matrix to a flat program of plane-wide XORs: expand
the matrix to its 8r x 8k GF(2) bit-matrix (``gf256.expand_to_bit_matrix``,
the same bit-matrix the card's GF kernel multiplies by), view every shard
as 8 bit-planes, and emit one XOR per set bit after greedy
common-subexpression elimination, per *Accelerating XOR-based Erasure
Coding using Program Optimization Techniques* (arXiv:2108.02692).

Bit-planes, not contiguous sub-packets: parity chunks are content-addressed
and golden-pinned, so the engine must give the table codecs' bytes.  Plane
v, byte t8, bit b holds bit v of shard byte 8*t8+b (little bit order), so
the XOR program computes exactly ``bits(mat (x) shards)``.

Schedules are pure data: ``(dst, src, kind)`` int32 triples over a plane
arena ``[inputs 0..8k) | temps | outputs]``, run by the native engine
(``cb_xor_exec`` in csrc/gf256.cpp, tiled so the arena stays in L1/L2) or
by :func:`apply_numpy`, the plain executor the tests hold it against.
Decode matrices are one per erasure pattern, so built schedules live in a
bounded LRU keyed by matrix digest (:func:`get_schedule`) that every
``NativeBackend.apply_matrix`` shares.
"""

from __future__ import annotations

import hashlib
import heapq
import threading
from collections import OrderedDict

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256

#: op kinds in the flat program: dst := src / dst ^= src / dst := 0
OP_COPY, OP_XOR, OP_ZERO = 0, 1, 2

#: greedy-CSE temp ceiling: bounds both schedule-build time and the
#: executor's arena (n_planes * tile bytes); extraction just stops at
#: the cap — correctness never depends on how far CSE got
MAX_TEMPS = 1024


class XorSchedule:
    """One compiled XOR program for a fixed GF(2^8) matrix.

    ``ops`` is a C-contiguous int32 ``[n, 3]`` array of
    ``(dst_plane, src_plane, kind)`` triples over the arena
    ``[0, 8k)`` input planes, ``[8k, 8k + n_temps)`` temporaries,
    ``[out_base, out_base + 8r)`` output planes, in execution order
    (every temp is defined before first use; each output plane's run
    starts with OP_COPY or OP_ZERO).
    """

    __slots__ = ("k", "r", "n_temps", "ops", "raw_xors", "digest")

    def __init__(self, k: int, r: int, n_temps: int, ops: np.ndarray,
                 raw_xors: int, digest: bytes) -> None:
        self.k = k
        self.r = r
        self.n_temps = n_temps
        self.ops = ops
        self.raw_xors = raw_xors
        self.digest = digest

    @property
    def n_planes(self) -> int:
        return 8 * self.k + self.n_temps + 8 * self.r

    @property
    def out_base(self) -> int:
        return 8 * self.k + self.n_temps

    @property
    def n_xors(self) -> int:
        """Scheduled XOR count (OP_XOR ops) — the CSE win metric:
        compare against ``raw_xors - 8r`` (one per set bit minus the
        copies that seed each output)."""
        return int(np.count_nonzero(self.ops[:, 2] == OP_XOR))


def matrix_digest(mat: np.ndarray) -> bytes:
    """Cache key for a coding matrix: shape-qualified content hash."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    h = hashlib.sha256()
    h.update(b"%dx%d:" % mat.shape)
    h.update(mat.tobytes())
    return h.digest()


def _cse(rows: list[set], n_in: int,
         max_temps: int) -> tuple[list[tuple[int, int, int]], int]:
    """Greedy pair-frequency CSE (2108.02692 §4): repeatedly hoist the
    plane pair shared by the most output rows into a temp, until no
    pair occurs twice (or the temp cap).  Mutates ``rows`` in place;
    returns ``(temp defs [(t, a, b)], n_temps)``."""
    counts: dict[tuple[int, int], int] = {}
    heap: list[tuple[int, int, int]] = []

    def bump(a: int, b: int, by: int) -> None:
        p = (a, b) if a < b else (b, a)
        c = counts.get(p, 0) + by
        if c <= 0:
            counts.pop(p, None)
            return
        counts[p] = c
        if c >= 2:
            heapq.heappush(heap, (-c, p[0], p[1]))

    # initial co-occurrence counts in one boolean matmul, not a Python
    # pair loop: C[a, b] = number of rows containing both planes
    m = np.zeros((len(rows), n_in), dtype=np.uint8)
    for ri, row in enumerate(rows):
        m[ri, list(row)] = 1
    co = m.T.astype(np.int32) @ m.astype(np.int32)
    for a, b in zip(*np.nonzero(np.triu(co, k=1) >= 2)):
        a, b = int(a), int(b)
        counts[(a, b)] = int(co[a, b])
        heapq.heappush(heap, (-int(co[a, b]), a, b))

    temps: list[tuple[int, int, int]] = []
    next_id = n_in
    while heap and len(temps) < max_temps:
        negc, a, b = heapq.heappop(heap)
        p = (a, b)
        if counts.get(p, 0) != -negc:
            continue  # stale heap entry (lazy deletion)
        if -negc < 2:
            break
        t = next_id
        next_id += 1
        temps.append((t, a, b))
        for row in rows:
            if a not in row or b not in row:
                continue
            row.discard(a)
            row.discard(b)
            for x in row:
                bump(a, x, -1)
                bump(b, x, -1)
                bump(t, x, +1)
            row.add(t)
        counts.pop(p, None)
    return temps, next_id - n_in


def verify_schedule(sched: XorSchedule, mat: np.ndarray) -> None:
    """Symbolic proof that ``sched`` computes exactly ``mat``.

    Replays the program over GF(2) with each input plane as a basis
    vector: every arena plane carries its coefficient row over the 8k
    input planes (COPY assigns the row, XOR adds it mod 2, ZERO clears
    it — temp-slot recycling falls out naturally since a slot is just
    whatever row was last written).  After the replay, output plane u
    must hold row u of ``gf256.expand_to_bit_matrix(mat)`` — the exact
    math every other backend computes — so a schedule that passes is
    byte-identical to the table codecs *by construction*, for every
    shard content, not just the fuzzed ones (2108.02692's verification
    step).  Raises :class:`ErasureError` on the first mismatching
    output row; runs at compile time (one [n_planes, 8k] bit matrix,
    one row op per scheduled op), so the always-on cost rides the slow
    path that already amortizes behind the ScheduleCache.
    """
    m2 = gf256.expand_to_bit_matrix(mat)
    r8, k8 = m2.shape
    if (r8, k8) != (8 * sched.r, 8 * sched.k):
        raise ErasureError(
            f"schedule geometry {sched.r}x{sched.k} does not match "
            f"matrix bit-expansion {r8 // 8}x{k8 // 8}")
    sym = np.zeros((sched.n_planes, k8), dtype=np.uint8)
    sym[:k8] = np.eye(k8, dtype=np.uint8)
    for dst, src, kind in sched.ops.tolist():
        if kind == OP_COPY:
            sym[dst] = sym[src]
        elif kind == OP_XOR:
            sym[dst] ^= sym[src]
        elif kind == OP_ZERO:
            sym[dst] = 0
        else:
            raise ErasureError(f"unknown op kind {kind} in schedule")
    got = sym[sched.out_base:]
    if not np.array_equal(got, m2):
        bad = int(np.nonzero((got != m2).any(axis=1))[0][0])
        raise ErasureError(
            f"xor schedule miscompiles matrix {sched.digest.hex()[:16]}: "
            f"output plane {bad} (row {bad // 8} bit {bad % 8}) computes "
            "a different GF(2) combination than the bit-matrix row — "
            "refusing to cache a program that would fork the wire format")


def build_schedule(mat: np.ndarray,
                   max_temps: int = MAX_TEMPS) -> XorSchedule:
    """Compile ``mat`` (uint8 [r, k], r >= 1) into an :class:`XorSchedule`.

    The program computes ``out[i] = XOR_j mat[i, j] (x) shards[j]`` in
    bit-plane layout; identity rows become single copies, zero rows an
    OP_ZERO (decode matrices contain both).  Every build is verified
    symbolically (:func:`verify_schedule`) before the schedule escapes
    to a caller or the cache.
    """
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2 or mat.shape[0] < 1 or mat.shape[1] < 1:
        raise ErasureError(f"cannot schedule a matrix shaped {mat.shape}")
    r, k = mat.shape
    digest = matrix_digest(mat)
    m2 = gf256.expand_to_bit_matrix(mat)
    raw_xors = int(m2.sum())
    rows: list[set] = [set(np.nonzero(m2[i])[0].tolist())
                       for i in range(8 * r)]
    temps, n_temps = _cse(rows, 8 * k, max_temps)

    # Logical order: a temp is defined (copy+xor pair) immediately
    # before its first use, outputs stream in row order — this keeps
    # temp liveness short so the slot recycling below can fold the
    # arena down (fewer live planes => bigger L1 tiles in the
    # executor, which measures as throughput: the tile loop's
    # per-op dispatch overhead amortizes over the tile length).
    defs = {t: (a, b) for t, a, b in temps}
    emitted: set = set()
    ops: list[tuple[int, int, int]] = []

    def emit_def(x: int) -> None:
        if x < 8 * k or x in emitted:
            return
        a, b = defs[x]
        emit_def(a)
        emit_def(b)
        emitted.add(x)
        ops.append((x, a, OP_COPY))
        ops.append((x, b, OP_XOR))

    out_base = 8 * k + n_temps
    for u, row in enumerate(rows):
        dst = out_base + u
        if not row:
            ops.append((dst, 0, OP_ZERO))
            continue
        terms = sorted(row)
        for x in terms:
            emit_def(x)
        ops.append((dst, terms[0], OP_COPY))
        for x in terms[1:]:
            ops.append((dst, x, OP_XOR))

    # Temp-slot recycling: remap logical temp ids onto a small pool of
    # arena slots freed at each temp's last use — full CSE with a
    # near-minimal arena.
    last_use: dict[int, int] = {}
    for i, (dst, src, kind) in enumerate(ops):
        if kind != OP_ZERO and src >= 8 * k:
            last_use[src] = i
        # a temp's own def ops keep it live at least to its last use
        if dst < out_base and dst >= 8 * k:
            last_use.setdefault(dst, i)
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0
    remapped: list[tuple[int, int, int]] = []
    for i, (dst, src, kind) in enumerate(ops):
        if kind != OP_ZERO and 8 * k <= src < out_base:
            src_slot = 8 * k + slot_of[src]
            if last_use[src] == i:
                heapq.heappush(free, slot_of.pop(src))
        elif kind == OP_ZERO:
            src_slot = 0
        else:
            src_slot = src
        if 8 * k <= dst < out_base:
            if dst not in slot_of:
                if free:
                    slot_of[dst] = heapq.heappop(free)
                else:
                    slot_of[dst] = n_slots
                    n_slots += 1
            dst_slot = 8 * k + slot_of[dst]
        else:
            dst_slot = dst
        remapped.append((dst_slot, src_slot, kind))
    # outputs sit right after the recycled temp pool
    shift = n_temps - n_slots
    final = [(d - shift if d >= out_base else d,
              s - shift if kind != OP_ZERO and s >= out_base else s,
              kind)
             for d, s, kind in remapped]
    arr = np.ascontiguousarray(np.array(final, dtype=np.int32))
    sched = XorSchedule(k, r, n_slots, arr, raw_xors, digest)
    verify_schedule(sched, mat)
    return sched


class ScheduleCache:
    """Bounded LRU of built schedules keyed by matrix digest.

    Decode matrices are per-erasure-pattern, so an unbounded cache
    would grow with observed failure patterns; the LRU keeps the hot
    working set (the encode matrix plus the patterns currently being
    repaired) and evicts cold patterns.  Thread-safe — worker threads
    of the host pipeline dispatch through it concurrently.
    """

    def __init__(self, maxsize: int = 64) -> None:
        if maxsize < 1:
            raise ErasureError("schedule cache needs maxsize >= 1")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, XorSchedule]" = OrderedDict()
        # weakly self-register so /metrics and /stats surface the LRU's
        # hit/miss/eviction counters (cb_xor_schedule_*) — the same
        # polled-source pattern as the chunk cache; the process-shared
        # _CACHE below lives for the process, per-test instances drop
        # out with their owners (the registry holds only a weakref)
        from chunky_bits_tpu_torch.obs.metrics import get_registry

        get_registry().register_source("xor_schedule", self)

    def get(self, mat: np.ndarray) -> XorSchedule:
        key = matrix_digest(mat)
        with self._lock:
            sched = self._entries.get(key)
            if sched is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return sched
            self.misses += 1
        # build outside the lock: a large decode-pattern build must not
        # stall concurrent encode dispatches (a racing duplicate build
        # is rare and merely wasted work — last writer wins)
        sched = build_schedule(mat)
        with self._lock:
            self._entries[key] = sched
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
        return sched

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def info(self) -> dict:
        with self._lock:
            return {"size": len(self._entries), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


#: the process-shared cache every native-backend dispatch goes through
_CACHE = ScheduleCache()


def get_schedule(mat: np.ndarray) -> XorSchedule:
    """Process-shared :class:`ScheduleCache` lookup (build on miss)."""
    return _CACHE.get(mat)


def schedule_cache_info() -> dict:
    """Introspection for tests and the bench grid."""
    return _CACHE.info()


# ---- numpy reference executor (identity oracle for the native engine) ----


def planes_of(rows: np.ndarray) -> np.ndarray:
    """Byte rows ``[n, S]`` (S % 8 == 0) -> bit-planes ``[8n, S/8]``:
    plane ``8i + v`` byte ``t8`` bit ``b`` = bit ``v`` of row ``i``
    byte ``8*t8 + b`` — the little-bit-order layout the native
    executor's movemask/transpose8 kernels produce."""
    n, s = rows.shape
    if s % 8:
        raise ErasureError("bit-plane layout needs S % 8 == 0")
    bits = np.unpackbits(rows.reshape(n, s, 1), axis=2,
                         bitorder="little")  # [n, S, 8]: bit v of byte t
    return np.packbits(bits.transpose(0, 2, 1), axis=2,
                       bitorder="little").reshape(8 * n, s // 8)


def bytes_of(planes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`planes_of`: ``[8n, P]`` planes -> ``[n, 8P]``."""
    n8, p = planes.shape
    if n8 % 8:
        raise ErasureError("plane count must be a multiple of 8")
    bits = np.unpackbits(planes.reshape(n8 // 8, 8, p, 1), axis=3,
                         bitorder="little")  # [n, 8, P, 8]
    # -> [n, P, 8(t%8), 8(v)] then pack the v axis into the byte value
    return np.packbits(bits.transpose(0, 2, 3, 1), axis=3,
                       bitorder="little").reshape(n8 // 8, 8 * p)


def apply_numpy(sched: XorSchedule, shards: np.ndarray) -> np.ndarray:
    """Reference executor: ``out[b, r, s] = mat (x) shards[b, k, s]``
    via the schedule, vectorized across the batch (each arena plane is
    one ``[b * P]`` row).  Byte-identical to every other backend by
    construction — the identity tests diff it against numpy/native."""
    if shards.ndim != 3 or shards.shape[1] != sched.k:
        raise ErasureError(
            f"expected shards [B, {sched.k}, S], got {shards.shape}")
    b, k, s = shards.shape
    if s % 8:
        raise ErasureError("xor schedule needs S % 8 == 0")
    out = np.zeros((b, sched.r, s), dtype=np.uint8)
    if b == 0 or s == 0:
        return out
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    p = s // 8
    arena = np.zeros((sched.n_planes, b * p), dtype=np.uint8)
    arena[:8 * k] = planes_of(
        shards.reshape(b * k, s)).reshape(b, 8 * k, p).transpose(
            1, 0, 2).reshape(8 * k, b * p)
    for dst, src, kind in sched.ops.tolist():
        if kind == OP_COPY:
            arena[dst] = arena[src]
        elif kind == OP_XOR:
            arena[dst] ^= arena[src]
        else:
            arena[dst] = 0
    outp = arena[sched.out_base:].reshape(8 * sched.r, b, p).transpose(
        1, 0, 2).reshape(b * 8 * sched.r, p)
    return bytes_of(outp).reshape(b, sched.r, s)
