"""HTTP object gateway over one cluster (the port of
``chunky_bits_tpu/gateway/http.py``).

Mirrors src/http.rs: GET/HEAD stream a file out of the cluster with full
single-range support (Range/Prefix/Suffix -> seek/take; 206 +
Content-Range; 416 when unsatisfiable; :27-95); Content-Length and
Content-Type headers (:77-81); 404 on a metadata miss (:86-89); PUT
streams the body through ``write_file`` with the default profile,
keeping Content-Type (:97-118).  The reference's ``bytes=a-b`` handler
reads ``b - a`` bytes and sends a Content-Range without the ``bytes ``
unit (http.rs:40-42); both are corrected here, as in the JAX package.

Beyond the reference, as in the JAX package:

- **Conditional GETs.**  Every GET/HEAD answer carries a strong ``ETag``
  derived from the file reference's content digests; ``If-None-Match``
  hits answer 304 with no body.
- **Zero-copy local-chunk streaming.**  A range inside one data chunk
  with a verified local replica streams with ``loop.sendfile`` (page
  cache to socket), bypassing fetch, verify and reassembly.  The digest
  is taken once (the native fused read+hash on the host pipeline) and
  memoized per (path, size, mtime_ns);
  ``$CHUNKY_BITS_TORCH_GATEWAY_SENDFILE`` turns the path off.
- **Admission control.**  In-flight GET bodies are bounded
  (``max_concurrent_gets``): excess requests get an immediate 503 +
  ``Retry-After``.  PUT ingests queue on a semaphore, under a size cap
  and a minimum rate.  With multi-tenant QoS on (the YAML ``qos:``
  mapping, cluster/qos.py), GET bodies and PUT ingests are admitted
  through the weighted-fair scheduler instead: each tenant (resolved once
  per request from ``X-Api-Key`` or a path prefix) queues briefly within
  its bounds, and only overflow sheds 503.
- **Access log and observability.**  One structured line per request
  through the app's ``Profiler.log_request``; ``/metrics`` (Prometheus
  text; the fleet view under a supervisor), ``/stats``, ``/healthz`` and
  ``/debug/traces``.  ``/scrub/status`` answers the scrub daemon's
  counters (``enabled: true``) when single-process ``serve`` runs one
  (the cluster's ``scrub_bytes_per_sec`` tunable above 0,
  cluster/scrub.py), else ``enabled: false``; a multi-worker fleet runs
  none, as in the JAX package.  ``/alerts`` answers the SLO engine's
  alert states (obs/slo.py; the fleet merge over the spool under a
  supervisor) when the cluster's ``slo_eval_s`` tunable is above 0, else
  ``enabled: false``.

The SLO engine and the QoS scheduler cost nothing when off: their modules
are not imported, no engine, scheduler or ticker task exists, and the
serve path tests one None.

Every PUT encodes through the cluster's shared encode batcher, and every
GET that reassembles rebuilds through the per-loop reconstruct batcher,
so on a ``cuda`` cluster both run the GF(2^8) kernel on the card.

Multi-worker serving (``serve(..., workers=N)``) lives in
gateway/workers.py: N pre-forked SO_REUSEPORT processes, each running
this module's app on its own loop, with its own cluster and CUDA context.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import os
import time
from collections import deque
from typing import Callable, Optional

from aiohttp import web

from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.errors import ChunkyBitsError, MetadataReadError
from chunky_bits_tpu_torch.file.file_reference import FileReference
from chunky_bits_tpu_torch.file.profiler import (Profiler, request_stats,
                                                 tenant_request_stats)
from chunky_bits_tpu_torch.obs import metrics as obs_metrics
from chunky_bits_tpu_torch.obs import tracing as obs_tracing
from chunky_bits_tpu_torch.utils import aio

log = logging.getLogger("chunky_bits_tpu_torch.gateway")

#: default bound on concurrent PUT ingests; excess requests queue.  The
#: reference accepts unbounded concurrent ingests (http.rs:97-118) — a
#: bound is a deliberate hardening for the one component facing
#: untrusted clients.
DEFAULT_MAX_CONCURRENT_PUTS = 32

#: a PUT slower than this average (bytes/sec, measured after a grace
#: window) is aborted with 408: with bounded concurrent ingests, a
#: trickling client would otherwise hold a slot forever (slow-loris).
#: 0 disables the floor.
DEFAULT_MIN_PUT_RATE = 256
_RATE_GRACE_SECONDS = 30.0

#: default bound on in-flight GET bodies per worker; the 257th
#: concurrent reader gets 503 + Retry-After instead of a queue slot.
#: Unlike the PUT semaphore (which queues — an ingest carries client
#: bytes that would be lost), reads are idempotent and retryable, so
#: shedding beats buffering.  <=0 = unbounded.
DEFAULT_MAX_CONCURRENT_GETS = 256

#: Retry-After fallback on a shed GET when no completion-rate signal
#: exists yet (cold worker) — short: a slot frees as soon as any
#: in-flight body finishes.  With traffic observed, the header is
#: DERIVED per shed: expected wait ≈ waiting requests over the recent
#: GET completion rate (see ``_retry_after`` in make_app), clamped to
#: [1, _RETRY_AFTER_MAX] so clients back off proportionally to the
#: actual queue instead of hammering a saturated worker every second.
_RETRY_AFTER_SECONDS = "1"

#: Retry-After derivation bounds: completion timestamps remembered
#: (rate window) and the clamp ceiling in seconds
_RETRY_AFTER_WINDOW = 64
_RETRY_AFTER_MAX = 30

#: bound on the (path, size, mtime_ns) -> verified-digest memo feeding
#: the sendfile fast path; oldest entries drop past this (FIFO — a
#: dropped entry only costs one re-verify)
_VERIFIED_MEMO_ENTRIES = 4096

#: the app's request-log profiler (``make_app`` stores it here; tests
#: read percentiles off it)
PROFILER_KEY: web.AppKey = web.AppKey("cb_profiler", Profiler)

#: the app's liveness/readiness state (``GET /healthz`` reads it; the
#: worker child flips ``draining`` on SIGTERM)
HEALTH_KEY: web.AppKey = web.AppKey("cb_health", object)

#: seconds between per-worker snapshot publications into the fleet
#: metrics spool (gateway/workers.py) — the staleness bound on OTHER
#: workers' series in an aggregated /metrics scrape (the scraped
#: worker's own series are always live)
_SPOOL_INTERVAL = 2.0


class HealthState:
    """Per-worker liveness/readiness: ``draining`` flips once shutdown
    has been requested, so a load balancer polling ``/healthz`` stops
    routing to this worker before its listener actually closes."""

    def __init__(self) -> None:
        self.started = time.monotonic()
        self.draining = False


class HttpRangeError(ValueError):
    pass


class _BodyTooLarge(ChunkyBitsError):
    pass


class _BodyTooSlow(ChunkyBitsError):
    pass


class _GuardedBody(aio.CountingReader):
    """Request-body reader enforcing the PUT limits: byte cap (via
    CountingReader) and a minimum average ingest rate.

    The rate floor is a deadline, not a post-read check: each read is
    bounded by the time left until the cumulative average would drop
    below ``min_rate``, so a client that sends *nothing at all* (aiohttp
    has no default body-read timeout) also trips it instead of pinning a
    PUT slot forever."""

    def __init__(self, content, max_bytes: Optional[int],
                 min_rate: int):
        super().__init__(content, max_bytes=max_bytes,
                         exc_factory=_BodyTooLarge)
        self._min_rate = min_rate
        self._started = time.monotonic()

    async def read(self, n: int = -1) -> bytes:
        if self._min_rate <= 0:
            return await super().read(n)
        # Two floors: the cumulative average must stay >= min_rate once
        # past the grace window (anti-trickle), and no single read may
        # stall longer than the grace window (anti burst-then-stall — a
        # client must not bank unbounded credit by front-loading bytes).
        avg_deadline = (self._started + _RATE_GRACE_SECONDS
                        + self.total / self._min_rate)
        timeout = min(_RATE_GRACE_SECONDS,
                      avg_deadline - time.monotonic())
        if timeout <= 0:
            raise _BodyTooSlow(f"ingest below {self._min_rate} B/s")
        try:
            return await asyncio.wait_for(super().read(n), timeout)
        except asyncio.TimeoutError:
            raise _BodyTooSlow(
                f"ingest below {self._min_rate} B/s") from None


def parse_http_range(s: str):
    """Parse a single ``bytes=`` range header (http.rs:151-220).
    Returns ("range", start, end_inclusive) | ("prefix", start) |
    ("suffix", length)."""
    unit, sep, spec = s.partition("=")
    if not sep:
        raise HttpRangeError("invalid format")
    if unit != "bytes":
        raise HttpRangeError("unknown unit")
    if "," in spec:
        raise HttpRangeError("multi-range not supported")
    start_s, sep, end_s = spec.partition("-")
    if not sep:
        raise HttpRangeError("invalid format")
    try:
        start = int(start_s) if start_s else None
        end = int(end_s) if end_s else None
    except ValueError as err:
        raise HttpRangeError("invalid integer") from err
    if start is not None and end is not None:
        if start > end:
            raise HttpRangeError("invalid length")
        return ("range", start, end)
    if start is not None:
        return ("prefix", start)
    if end is not None:
        return ("suffix", end)
    raise HttpRangeError("no range specified")


def file_ref_etag(file_ref: FileReference) -> str:
    """Strong ETag for a file reference: sha256 over its CONTENT
    identity — length, content type, and every chunk's content digest
    per part — quoted per RFC 9110.  Locations are deliberately
    excluded: a resilver or rebalance rewrites placement for unchanged
    bytes, and a placement change must not invalidate every client's
    cached validator (nor let two workers with differently-aged
    metadata caches serve different tags for the same bytes).  Chunk
    digests are content-addressed, so equal tags imply byte-identical
    objects across workers and restarts.  Memoized on the ref object:
    the cluster's metadata cache hands the same parsed instance to
    every hot GET."""
    cached = getattr(file_ref, "_gateway_etag", None)
    if cached is not None:
        return cached
    canon = json.dumps({
        "length": file_ref.length,
        "content_type": file_ref.content_type,
        "compression": file_ref.compression,
        "parts": [
            {"chunksize": part.chunksize,
             "data": [str(c.hash) for c in part.data],
             "parity": [str(c.hash) for c in part.parity]}
            for part in file_ref.parts
        ],
    }, sort_keys=True, separators=(",", ":"))
    etag = f'"{hashlib.sha256(canon.encode()).hexdigest()[:32]}"'
    file_ref._gateway_etag = etag
    return etag


def _if_none_match_hits(header: Optional[str], etag: str) -> bool:
    """True when an ``If-None-Match`` header matches ``etag`` (RFC 9110
    §13.1.2: ``*`` matches anything; weak comparison, so a ``W/`` prefix
    on the client's copy still hits)."""
    if header is None:
        return False
    for token in header.split(","):
        token = token.strip()
        if token == "*":
            return True
        if token.startswith("W/"):
            token = token[2:]
        if token == etag:
            return True
    return False


def _covering_chunk(file_ref: FileReference, seek: int, length: int):
    """(chunk, chunksize, offset_in_chunk) when the byte span
    [seek, seek+length) lies inside ONE data chunk of one part — the
    precondition for serving it straight off a local chunk file — else
    None.  Parity chunks never qualify (their bytes are not file
    bytes), nor do spans crossing a chunk or part boundary."""
    from chunky_bits_tpu_torch.ops.backend import KNOWN_CODES

    part_off = 0
    for part in file_ref.parts:
        part_len = part.len_bytes()
        if seek < part_off + part_len:
            if seek + length > part_off + part_len:
                return None  # spans parts
            if part.code not in KNOWN_CODES:
                # a foreign code could be non-systematic — raw chunk
                # bytes may not be file bytes, so the generic path must
                # raise its clean per-part error instead of sendfile
                # serving a guess (file_part.require_known_code)
                return None
            local = seek - part_off
            csize = part.chunksize
            if csize <= 0:
                return None
            idx = local // csize
            if idx >= len(part.data):
                return None
            if local + length > (idx + 1) * csize:
                return None  # spans chunks
            return part.data[idx], csize, local - idx * csize
        part_off += part_len
    return None


def _sha256_extent(path: str, offset: int,
                   length: Optional[int]) -> bytes:
    """Streaming sha256 of a file extent (the sendfile path's verify);
    ``length`` None hashes to EOF.  Runs on the host pipeline's workers,
    never on the loop."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        f.seek(offset)
        remaining = length
        while remaining is None or remaining > 0:
            n = 1 << 20 if remaining is None else min(1 << 20, remaining)
            data = f.read(n)
            if not data:
                break
            if remaining is not None:
                remaining -= len(data)
            h.update(data)
    return h.digest()


def make_app(cluster: Cluster,
             max_put_bytes: Optional[int] = None,
             max_concurrent_puts: int = DEFAULT_MAX_CONCURRENT_PUTS,
             min_put_rate: int = DEFAULT_MIN_PUT_RATE,
             max_concurrent_gets: int = DEFAULT_MAX_CONCURRENT_GETS,
             sendfile: Optional[bool] = None,
             profiler: Optional[Profiler] = None,
             scrub=None,
             metrics_spool: Optional[str] = None,
             health_state: Optional[HealthState] = None
             ) -> web.Application:
    # <=0 means unbounded, like the reference's ingest (and matching
    # min_put_rate's "0 disables" convention)
    put_sem = (asyncio.Semaphore(max_concurrent_puts)
               if max_concurrent_puts > 0 else contextlib.nullcontext())

    # the process metrics registry: the durable sink every stat source
    # in this app feeds (obs/metrics.py) — /metrics and /stats read it;
    # the fleet spool (multi-worker serve) aggregates it across workers
    registry = obs_metrics.get_registry()
    worker_id = str(os.getpid())
    # the fleet-aggregation probe: one gauge that is 1 for every live
    # worker, so a merged scrape shows exactly which workers reported
    registry.gauge("cb_worker_up",
                   "this worker process is serving").set(1)
    shed_counter = registry.counter(
        "cb_gateway_gets_shed_total",
        "GETs shed with 503 by read admission control")
    put_reject_counter = registry.counter(
        "cb_gateway_puts_rejected_total", "PUT ingests rejected",
        labels=("reason",))
    inflight_gauge = registry.gauge(
        "cb_gateway_gets_in_flight", "GET bodies currently streaming")

    if health_state is None:
        health_state = HealthState()

    # slow-request tracing threshold (obs/tracing.py), read at app
    # build like every other knob; 0 = tracing off (the default)
    trace_slow_s = max(cluster.tunables.trace_slow_ms, 0.0) / 1000.0

    # sendfile defaults from the tunable, read here at app build (the
    # gateway's first-use moment, like every other knob)
    if sendfile is None:
        from chunky_bits_tpu_torch.cluster.tunables import gateway_sendfile

        sendfile = gateway_sendfile()

    # SLO engine (obs/slo.py): windowed burn-rate alerting over this
    # registry's snapshots, built only when the cluster's `slo_eval_s`
    # tunable asks for it (off: no ring, no ticker task, /alerts answers
    # enabled: false).  Objectives come from the YAML `slo:` mapping
    slo_eval = max(cluster.tunables.slo_eval_s, 0.0)
    slo_engine = None
    if slo_eval > 0:
        from chunky_bits_tpu_torch.obs import slo as obs_slo

        slo_engine = obs_slo.SloEngine(
            objectives=obs_slo.SloObjectives.from_obj(
                cluster.tunables.slo or None),
            registry=registry)

    # the app's own profiler collects the per-request access log; the
    # cluster's serve-path counters (cache, health) ride along so one
    # report shows the whole serving picture
    if profiler is None:
        profiler = Profiler()
    profiler.attach_health(cluster.health_scoreboard())
    if scrub is not None:
        profiler.attach_scrub(scrub)
    if slo_engine is not None:
        profiler.attach_slo(slo_engine)

    # Multi-tenant QoS scheduler (gateway/qos.py + cluster/qos.py):
    # weighted-fair admission in front of GET bodies and PUT ingest, off
    # by default.  The enablement check reads only the YAML dict and the
    # env flag, so the qos modules are not even imported when off.  When
    # on, the scheduler is also the pressure and hedge authority: scrub
    # and planner-repair I/O throttle against read pressure (client reads
    # > writes > hedges > scrub/repair), and the scoreboard's hedge
    # launches go through its SLO-aware advisor
    _qos_on = (cluster.tunables.qos or {}).get("enabled")
    if _qos_on is None:
        from chunky_bits_tpu_torch.cluster.tunables import qos_enabled

        _qos_on = qos_enabled()
    qos_sched = None
    # the shed exception the admission sites catch; an empty tuple (qos
    # off) catches nothing
    qos_shed_exc: tuple = ()
    if _qos_on:
        from chunky_bits_tpu_torch.cluster.qos import QosShedError
        from chunky_bits_tpu_torch.gateway import qos as gw_qos

        qos_shed_exc = (QosShedError,)
        qos_sched = gw_qos.maybe_build(
            cluster,
            read_capacity=(max_concurrent_gets
                           if max_concurrent_gets > 0
                           else DEFAULT_MAX_CONCURRENT_GETS),
            write_capacity=(max_concurrent_puts
                            if max_concurrent_puts > 0
                            else DEFAULT_MAX_CONCURRENT_PUTS))
    if qos_sched is not None:
        profiler.attach_qos(qos_sched)
        # hedges yield to client traffic: the scoreboard consults the
        # scheduler before arming or firing (suppression burns no budget)
        cluster.health_scoreboard().set_hedge_gate(qos_sched.allow_hedge)
        if scrub is not None:
            # scrub and repair I/O ride one token bucket; pressure scales
            # its accrual down (floor 5%: degrade, never hang)
            scrub.set_pressure(qos_sched.pressure)

    # build/configuration identity for the fleet view: one static
    # gauge whose labels say which version/backend/flags THIS worker
    # runs — merged /metrics labels it per worker, so a mixed-version
    # or mixed-flag supervisor fleet is visible in one scrape
    from chunky_bits_tpu_torch import __version__ as _pkg_version
    from chunky_bits_tpu_torch.cluster.tunables import (erasure_code,
                                                        xor_schedule_enabled)
    from chunky_bits_tpu_torch.ops.backend import canonical_backend_name

    obs_metrics.record_build_info(
        _pkg_version, canonical_backend_name(cluster.tunables.backend),
        {
            "code": erasure_code(),
            "xor_schedule": "on" if xor_schedule_enabled() else "off",
            "sendfile": "on" if sendfile else "off",
            "scrub": "on" if scrub is not None else "off",
            "slo": "on" if slo_engine is not None else "off",
            "qos": "on" if qos_sched is not None else "off",
        }, registry)

    # PUT ingest compute (per-shard SHA-256 + per-stripe GF encode) runs
    # on the cluster's host pipeline workers, so the event loop's socket
    # receive overlaps encode+hash on every scheduler core instead of
    # sharing one thread with it.  Resolve (and thereby spawn) the
    # workers now: the first request shouldn't pay the warm-up, and a
    # misconfigured tunables.host_threads should fail at serve start,
    # not mid-ingest.  The read path's verify hops (incl. the sendfile
    # digest check) draw from the same pipeline.
    pipe = cluster.host_pipeline()

    # Every GET/PUT of this app feeds the cluster's ONE location-health
    # scoreboard (cluster/health.py) through the shared LocationContext
    # — concurrent requests therefore share latency/error memory and
    # the hedge budget, the serve-path analogue of the shared encode
    # batcher.  On failures the per-node table goes to the log so a
    # degraded cluster is diagnosable from the gateway side alone.
    health = cluster.health_scoreboard()

    # in-flight GET bodies (admission control); a plain counter — all
    # bookkeeping happens on the app's loop
    gets_in_flight = {"now": 0}

    # GET-body completion timestamps, bounded ring — the observed
    # service rate the derived Retry-After reads.  Loop-local like
    # gets_in_flight (appended only from handle_get's finally).
    get_done: deque = deque(maxlen=_RETRY_AFTER_WINDOW)

    def _retry_after() -> str:
        """Retry-After for a shed request, derived from load: expected
        wait for a slot ≈ (requests ahead + 1) / observed GET-body
        completion rate over the recent window, clamped to
        [1, _RETRY_AFTER_MAX] seconds.  A cold worker (no completions
        yet, or a stalled window) answers the 1-second fallback — the
        old hardcoded behavior — rather than guessing."""
        if len(get_done) < 2:
            return _RETRY_AFTER_SECONDS
        span = time.monotonic() - get_done[0]
        if span <= 0:
            return _RETRY_AFTER_SECONDS
        rate = len(get_done) / span      # completions per second
        ahead = gets_in_flight["now"]
        if qos_sched is not None:
            ahead += qos_sched.queued("read")
        wait = (ahead + 1) / rate
        return str(max(1, min(int(wait + 0.5), _RETRY_AFTER_MAX)))

    # (path, 0, size) -> (size, mtime_ns) of local chunk files whose
    # digest verified, FIFO-bounded and per app (= per worker process),
    # like the chunk cache.  Chunk files are published by atomic rename
    # and named by their digest, so the same path, size and mtime_ns is
    # the same content.
    verified_memo: dict[tuple, object] = {}

    def _memo_insert(key: tuple, token: object) -> None:
        verified_memo[key] = token
        while len(verified_memo) > _VERIFIED_MEMO_ENTRIES:
            verified_memo.pop(next(iter(verified_memo)))

    async def _verify_local_chunk(chunk, location, chunksize: int
                                  ) -> Optional[tuple[str, int]]:
        """(file path, byte offset) to stream ``chunk``'s verified bytes
        from (a whole local chunk file, or a live extent inside a packed
        slab), or None when this replica cannot serve the zero-copy path
        (wrong size, corrupt, missing).  A full digest at first sight
        (the native fused read+hash, or a streaming hashlib pass on the
        host pipeline where it does not apply), the memo afterwards.  A
        slab extent's memo key binds the chunk digest: slab bytes are
        write-once, but a compaction of an emptied store can reuse an
        extent address."""
        from chunky_bits_tpu_torch.file.file_part import _hash_local_fused

        if location.is_slab():
            ext = await asyncio.to_thread(location.slab_extent)
            if ext is None:
                return None
            path, base, ext_len = ext
            if ext_len != chunksize:
                return None
            key = (path, base, ext_len, chunk.hash.value.digest)
            if verified_memo.get(key) == "extent":
                return (path, base)
            token: object = "extent"
        else:
            path, base = location.target, 0
            try:
                st = await asyncio.to_thread(os.stat, path)
            except OSError:
                return None
            if st.st_size != chunksize:
                return None
            key = (path, 0, chunksize)
            token = (st.st_size, st.st_mtime_ns)
            if verified_memo.get(key) == token:
                return (path, 0)
        cx = cluster.tunables.location_context()
        digest = await _hash_local_fused(chunk, location, cx, pipe)
        if digest is None:
            try:
                digest = await pipe.run(
                    "verify",
                    lambda: _sha256_extent(path, base, chunksize),
                    nbytes=chunksize)
            except OSError:
                return None
        if digest != chunk.hash.value.digest:
            # a corrupt replica: a demerit for the node, and the generic
            # read path (which falls through or reconstructs) takes over
            health.record(location, False)
            return None
        _memo_insert(key, token)
        return (path, base)

    async def _sendfile_response(request: web.Request, status: int,
                                 headers: dict, path: str,
                                 offset: int, count: int
                                 ) -> Optional[web.StreamResponse]:
        """Stream ``count`` bytes of ``path`` from ``offset`` via
        ``loop.sendfile`` (the aiohttp FileResponse pattern: prepare,
        sendfile on the raw transport, write_eof).  Returns None when
        the file cannot be opened (caller falls back to reassembly);
        after headers are on the wire, socket-level failures abort the
        connection exactly like the reassembly path's mid-stream
        abort.  The file never leaks: a cancelled open is closed when
        its thread finishes, and the close is a local syscall made
        inline, so a cancellation cannot skip it."""
        try:
            f = await aio.open_in_thread(lambda: open(path, "rb"),
                                         lambda h: h.close())
        except OSError:
            return None
        try:
            resp = web.StreamResponse(status=status, headers=headers)
            await resp.prepare(request)
            transport = request.transport
            if transport is None:  # client already gone
                return resp
            loop = asyncio.get_running_loop()
            try:
                try:
                    await loop.sendfile(transport, f, offset, count)
                except NotImplementedError:
                    # no OS sendfile on this transport: bounded chunked
                    # copy through the normal writer
                    await asyncio.to_thread(f.seek, offset)
                    remaining = count
                    while remaining > 0:
                        data = await asyncio.to_thread(
                            f.read, min(1 << 20, remaining))
                        if not data:
                            break
                        remaining -= len(data)
                        await resp.write(data)
            except (ConnectionError, OSError) as err:
                # the file side verified before we got here, so this is
                # the socket: abort the connection like the reassembly
                # path does mid-stream
                log.error("GET %s sendfile aborted: %s",
                          request.path, err)
                resp.force_close()
                if request.transport is not None:
                    request.transport.close()
                return resp
            await resp.write_eof()
            return resp
        finally:
            f.close()

    def _serve_source(file_ref: FileReference, cache,
                      seek: int, length: int) -> str:
        """Access-log tag for a reassembly-path read: "cache" when
        every data chunk of every part the span touches is already in
        the read cache (contains() probes — no hit-count skew), else
        "store"."""
        if cache is None:
            return "store"
        end = seek + length
        part_off = 0
        for part in file_ref.parts:
            part_len = part.len_bytes()
            if part_off < end and part_off + part_len > seek:
                for chunk in part.data:
                    key = chunk.cache_key()
                    if key is None or not cache.contains(key):
                        return "store"
            part_off += part_len
            if part_off >= end:
                break
        return "cache"

    async def handle_get(request: web.Request) -> web.StreamResponse:
        path = request.match_info["path"]
        try:
            file_ref = await cluster.get_file_ref(path)
        except MetadataReadError:
            return web.Response(status=404)
        except ChunkyBitsError as err:
            # detail goes to the log only: error text can embed internal
            # node URLs / filesystem paths untrusted clients must not see
            log.error("GET %s failed: %s", path, err)
            return web.Response(status=500, text="error: internal error\n")
        etag = file_ref_etag(file_ref)
        # conditional GET: evaluated before Range (RFC 9110 §13.2.2) —
        # a matching validator answers 304 with zero body bytes
        if _if_none_match_hits(request.headers.get("If-None-Match"),
                               etag):
            request["cb_source"] = "cond"
            return web.Response(status=304, headers={"ETag": etag})
        total = file_ref.len_bytes()
        # the cluster's serve-path builder: per-loop shared reconstruct
        # batcher (concurrent GETs coalesce their decode dispatches, K1
        # on a `cuda` cluster) and, when `tunables.cache_bytes` is set,
        # the content-addressed chunk cache.  Range requests ride the same
        # path: the cache only ever holds whole verified chunks — the
        # seek/take trim below happens at the edge, after the cache.
        builder = cluster.file_read_builder(file_ref)
        status = 200
        headers = {"ETag": etag}
        range_header = request.headers.get("Range")
        parsed = None
        if range_header is not None:
            try:
                parsed = parse_http_range(range_header)
            except HttpRangeError:
                # RFC 9110: an unparseable/unknown-unit/multi-range header
                # is ignored, not rejected; 416 is only for unsatisfiable
                # ranges.
                parsed = None
        if parsed is not None:
            if parsed[0] == "range":
                _, start, end = parsed
                builder = builder.with_seek(start).with_take(end - start + 1)
            elif parsed[0] == "prefix":
                builder = builder.with_seek(parsed[1])
            else:  # suffix
                # RFC 9110 §14.1.2: a suffix length >= the representation
                # length selects the ENTIRE representation (it is
                # satisfiable), so clamp rather than 416
                length = min(parsed[1], total)
                builder = builder.with_seek(total - length).with_take(length)
            if builder.len_bytes() == 0:
                # unsatisfiable: RFC 9110 §14.4 — Content-Range carries
                # the selected representation's length so the client
                # can re-range without a probe request
                return web.Response(
                    status=416,
                    headers={"Content-Range": f"bytes */{total}",
                             "ETag": etag})
            seek = builder.seek
            end_excl = seek + builder.len_bytes()
            headers["Content-Range"] = \
                f"bytes {seek}-{end_excl - 1}/{total}"
            status = 206
        length = builder.len_bytes()
        headers["Content-Length"] = str(length)
        if file_ref.content_type:
            headers["Content-Type"] = file_ref.content_type
        if request.method == "HEAD":
            # shares the whole resolution path above (ETag, ranges,
            # 416, Content-Length/Type) but never touches chunk bytes
            request["cb_source"] = "meta"
            resp = web.StreamResponse(status=status, headers=headers)
            await resp.prepare(request)
            return resp
        # Admission control, here and not at handler entry: only
        # in-flight GET bodies occupy slots, so HEAD, 304 revalidations,
        # 404s and 416s (all body-free and cheap) are always answered
        # even at the bound.  Shed, don't queue: an immediate 503 with
        # Retry-After keeps worker memory bounded under a client storm.
        # With QoS on, admission runs through the weighted-fair scheduler
        # instead: requests queue briefly (bounded depth and wait) per
        # tenant, so one flooding tenant cannot starve the others, and
        # overflow still sheds 503.  A failed acquire holds no slot; a
        # granted one is released in the finally below
        if qos_sched is not None:
            try:
                # lint: lock-discipline-ok a failed acquire grants no
                # slot (shed/cancel paths hold nothing to release);
                # granted slots release in the try/finally just below
                await qos_sched.acquire("read", request["cb_tenant"],
                                        cost=length)
            except qos_shed_exc:
                shed_counter.inc()
                return web.Response(
                    status=503, text="error: too many in-flight reads\n",
                    headers={"Retry-After": _retry_after()})
        elif (max_concurrent_gets > 0
                and gets_in_flight["now"] >= max_concurrent_gets):
            shed_counter.inc()
            return web.Response(
                status=503, text="error: too many in-flight reads\n",
                headers={"Retry-After": _retry_after()})
        try:
            gets_in_flight["now"] += 1
            inflight_gauge.set(gets_in_flight["now"])
            return await _serve_get_body(request, path, file_ref,
                                         builder, status, headers,
                                         length)
        finally:
            gets_in_flight["now"] -= 1
            inflight_gauge.set(gets_in_flight["now"])
            get_done.append(time.monotonic())
            if qos_sched is not None:
                qos_sched.release("read")

    async def _serve_get_body(request: web.Request, path: str,
                              file_ref: FileReference, builder,
                              status: int, headers: dict, length: int
                              ) -> web.StreamResponse:
        cache = builder.cache
        # zero-copy fast path: a span inside ONE data chunk with a
        # verified local replica streams straight from the page cache.
        # A chunk already in the read cache is served from memory by
        # the generic path instead (cheaper than re-stating the file).
        if sendfile and length > 0:
            covered = _covering_chunk(file_ref, builder.seek, length)
            if covered is not None:
                chunk, csize, off = covered
                key = chunk.cache_key()
                in_cache = (cache is not None and key is not None
                            and cache.contains(key))
                if not in_cache:
                    for location in chunk.locations:
                        if not (location.is_local()
                                or location.is_slab()) \
                                or location.range.is_specified():
                            continue
                        served = await _verify_local_chunk(
                            chunk, location, csize)
                        if served is not None:
                            path_, base = served
                            resp = await _sendfile_response(
                                request, status, headers,
                                path_, base + off, length)
                            if resp is not None:
                                request["cb_source"] = "sendfile"
                                return resp
        request["cb_source"] = _serve_source(file_ref, cache,
                                             builder.seek, length)
        resp = web.StreamResponse(status=status, headers=headers)
        await resp.prepare(request)
        try:
            async for chunk in builder.stream():
                await resp.write(chunk)
        except ChunkyBitsError as err:
            # Degraded beyond repair (>p chunks gone) or a storage-node
            # failure mid-file.  Status and Content-Length are already on
            # the wire, so the only honest signal left is an aborted
            # connection — the client sees a short body, never a clean
            # EOF that would pass truncated data off as the object.
            # Detail goes to the log only (error text can embed internal
            # node URLs / filesystem paths).
            log.error("GET %s aborted mid-stream: %s", path, err)
            log.error("location health at abort: %s", health.stats())
            resp.force_close()
            if request.transport is not None:
                request.transport.close()
            return resp
        await resp.write_eof()
        return resp

    def put_reject(status: int, text: str) -> web.Response:
        """An error response for a PUT whose body was not (fully) read.
        The connection is force-closed: answering early and then reusing
        the keep-alive stream leaves the unread body bytes in front of
        the next request's head — observed as the follow-up request
        hanging forever against aiohttp 3.11's client, which returns the
        half-sent connection to its pool once the early response lands."""
        resp = web.Response(status=status, text=text)
        resp.force_close()
        return resp

    async def handle_put(request: web.Request) -> web.Response:
        path = request.match_info["path"]
        profile = cluster.get_profile(None)
        content_type: Optional[str] = request.headers.get("Content-Type")

        declared = request.headers.get("Content-Length")
        if max_put_bytes is not None:
            if declared is not None and int(declared) > max_put_bytes:
                put_reject_counter.labels(reason="too_large").inc()
                return put_reject(413, "error: body too large\n")

        # With QoS on, write admission runs through the weighted-fair
        # scheduler before the body is read: grants stay <= the write
        # capacity (= the put_sem bound), so put_sem below never waits and
        # stays as the backstop.  Write grants are deferred while client
        # reads queue (reads > writes), bounded by the wait deadline
        if qos_sched is not None:
            cost = int(declared) if declared is not None else None
            try:
                # lint: lock-discipline-ok a failed acquire grants no
                # slot (shed/cancel paths hold nothing to release);
                # granted slots release in the try/finally just below
                await qos_sched.acquire("write", request["cb_tenant"],
                                        cost=cost)
            except qos_shed_exc:
                put_reject_counter.labels(reason="shed").inc()
                resp = put_reject(
                    503, "error: too many in-flight writes\n")
                resp.headers["Retry-After"] = _retry_after()
                return resp
        try:
            # A rejected or aborted ingest can leave orphaned shards; they
            # are content-addressed (possibly shared with other files), so
            # they are left to the reference-checking find-unused-hashes
            # GC rather than deleted blindly.
            async with put_sem:
                try:
                    await cluster.write_file(
                        path,
                        _GuardedBody(request.content, max_put_bytes,
                                     min_put_rate),
                        profile, content_type)
                except _BodyTooLarge:
                    put_reject_counter.labels(reason="too_large").inc()
                    return put_reject(413, "error: body too large\n")
                except _BodyTooSlow:
                    put_reject_counter.labels(reason="too_slow").inc()
                    return put_reject(408, "error: ingest too slow\n")
                except ChunkyBitsError as err:
                    log.error("PUT %s failed: %s", path, err)
                    log.error("location health at failure: %s",
                              health.stats())
                    put_reject_counter.labels(reason="error").inc()
                    return put_reject(500, "error: internal error\n")
        finally:
            if qos_sched is not None:
                qos_sched.release("write")
        return web.Response(status=200)

    @web.middleware
    async def access_log(request: web.Request, handler
                         ) -> web.StreamResponse:
        """One structured record per request — the log line operators
        grep and the percentiles ``/stats`` reports are the same
        numbers (Profiler.log_request -> request_stats; log_request
        also feeds the metrics registry, so /metrics percentiles are
        the same numbers again).  ``bytes`` is the declared body
        length: an aborted stream still logs the length it promised
        (the abort itself is logged separately).

        When ``tunables.trace_slow_ms`` arms tracing, this middleware
        is also the trace root: it mints (or accepts via
        ``X-Chunky-Trace``) the request's trace id and parks the trace
        in the context — every task the handler spawns inherits it,
        and pipeline jobs carry it across the thread boundary."""
        start = time.monotonic()
        status = 500
        nbytes = 0
        # the tenant resolves here, once per request, before any handler
        # runs; both admission sites and the log read it.  Resolution is
        # total over the closed table (unmatched -> "other")
        if qos_sched is not None:
            request["cb_tenant"] = gw_qos.resolve_request_tenant(
                qos_sched.config, request)
        trace = token = None
        if trace_slow_s > 0:
            trace_id = obs_tracing.clean_id(
                request.headers.get("X-Chunky-Trace"))
            trace, token = obs_tracing.start(trace_id)
        try:
            resp = await handler(request)
            status = resp.status
            if request.method != "HEAD" and status < 300:
                nbytes = resp.content_length or 0
            return resp
        except web.HTTPException as err:
            # the router answers unroutable methods (405 etc.) by
            # raising; log the status the client actually sees, not a
            # phantom 500 that would inflate error-rate stats
            status = err.status
            raise
        finally:
            duration = time.monotonic() - start
            source = request.get("cb_source", "-")
            tenant = request.get("cb_tenant", "-")
            profiler.log_request(request.method, request.path, status,
                                 nbytes, duration, source, tenant)
            if qos_sched is not None and status < 500:
                # completion-latency sample for the SLO-aware hedge
                # advisor: the numbers the access log just recorded
                if request.method == "GET":
                    qos_sched.note_request("read", duration)
                elif request.method == "PUT":
                    qos_sched.note_request("write", duration)
            if trace is not None and token is not None:
                trace.add("request", "gateway", start, duration,
                          str(status))
                obs_tracing.finish(
                    trace, token, duration=duration,
                    slow_s=trace_slow_s,
                    meta={"method": request.method,
                          "path": request.path, "status": status,
                          "source": source, "worker": worker_id})
            log.info(
                "req method=%s path=%s status=%d bytes=%d ms=%.2f "
                "source=%s tenant=%s", request.method, request.path,
                status, nbytes, duration * 1000.0, source, tenant)

    async def handle_scrub_status(request: web.Request) -> web.Response:
        """Scrub observability: counters + running state as JSON.
        ``enabled: false`` when no daemon is attached (the tunable is
        off, or a multi-worker fleet where scrub runs as its own
        ``chunky-bits scrub`` job instead of per worker)."""
        request["cb_source"] = "meta"
        if scrub is None:
            payload = {"enabled": False}
        else:
            payload = {"enabled": True, **scrub.stats().to_obj()}
        return web.json_response(payload)

    async def handle_metrics(request: web.Request) -> web.Response:
        """Prometheus text exposition.  Single-process: this worker's
        registry.  Under a multi-worker supervisor (``metrics_spool``
        set): the FLEET view — this worker's live snapshot merged with
        every sibling's spooled one (counters/histograms summed, gauges
        labeled by worker) — so one scrape covers the whole
        SO_REUSEPORT fleet no matter which worker the kernel picked."""
        request["cb_source"] = "meta"
        own = registry.snapshot()
        if metrics_spool is not None:
            merged = await asyncio.to_thread(
                obs_metrics.fleet_snapshot, metrics_spool,
                (worker_id, own))
        else:
            merged = obs_metrics.merge_snapshots([(None, own)])
        return web.Response(
            text=obs_metrics.render_exposition(merged),
            content_type="text/plain", charset="utf-8")

    async def handle_alerts(request: web.Request) -> web.Response:
        """SLO alert states as JSON (obs/slo.py); ``enabled: false`` when
        the engine is off (``slo_eval_s`` unset, the default).  Under a
        multi-worker supervisor the payload adds the fleet view, merged
        from the snapshot spool /metrics reads: per rule, the max state
        across live workers, with the per-worker breakdown; a spool-reaped
        dead worker drops out of the merge."""
        request["cb_source"] = "meta"
        if slo_engine is None:
            return web.json_response({"enabled": False})
        payload = slo_engine.to_obj()
        payload["worker"] = worker_id
        if metrics_spool is not None:
            entries = await asyncio.to_thread(
                obs_metrics.load_spool, metrics_spool)
            entries = [(wid, snap) for wid, snap in entries
                       if wid != worker_id]
            entries.append((worker_id, registry.snapshot()))
            payload["fleet"] = obs_slo.fleet_alert_states(entries)
        return web.json_response(payload)

    async def handle_stats(request: web.Request) -> web.Response:
        """JSON snapshot twin of /metrics (this worker only — machine
        consumers wanting the fleet read /metrics), plus the access-log
        summary computed by the same ``request_stats``/``percentile``
        code the access log feeds."""
        request["cb_source"] = "meta"
        payload = {
            "worker": worker_id,
            "requests": request_stats(
                profiler.peek_requests()).to_obj(),
            "dropped": profiler.drop_counts(),
            "slo": ({"enabled": True, **slo_engine.stats().to_obj()}
                    if slo_engine is not None else {"enabled": False}),
            "qos": (qos_sched.stats().to_obj()
                    if qos_sched is not None else {"enabled": False}),
            "metrics": registry.snapshot(),
        }
        if qos_sched is not None:
            # per-tenant access-log percentiles, the same request_stats
            # code as the aggregate block above
            payload["requests_by_tenant"] = {
                t: st.to_obj() for t, st in tenant_request_stats(
                    profiler.peek_requests()).items()}
        return web.json_response(payload)

    async def handle_healthz(request: web.Request) -> web.Response:
        """Per-worker liveness/readiness: 200 while serving, 503 once
        draining (shutdown requested, listener still up) — the signal a
        balancer needs to stop routing here before connections break."""
        request["cb_source"] = "meta"
        if health_state.draining:
            return web.json_response(
                {"status": "draining", "worker": worker_id},
                status=503)
        return web.json_response({
            "status": "ok", "worker": worker_id,
            "uptime_s": round(time.monotonic() - health_state.started,
                              3)})

    async def handle_debug_traces(request: web.Request) -> web.Response:
        """The slowest-N retained traces (per worker — a trace is one
        worker's story), slowest first, with per-plane time so "which
        plane ate the p999" reads straight off the payload."""
        request["cb_source"] = "meta"
        return web.json_response({
            "enabled": trace_slow_s > 0,
            "trace_slow_ms": trace_slow_s * 1000.0,
            "worker": worker_id,
            "traces": obs_tracing.buffer().snapshot(),
        })

    # always-on event-loop lag sampler + (multi-worker) the periodic
    # snapshot publication the fleet /metrics merge reads; both bound
    # to the app's lifecycle so tests and restarts leak nothing
    lag_monitor = obs_metrics.LoopLagMonitor(registry)
    spool_task: dict = {"task": None}
    slo_task: dict = {"task": None}

    async def _slo_ticker() -> None:
        """The engine's cadence: one registry snapshot per `slo_eval_s`
        into the ring.  Under a supervisor the engine evaluates the
        worker-labeled fleet view (this worker live, siblings off the
        spool, every sample tagged `worker=`), not the summed /metrics
        merge, whose per-series reset clamp would misread one sibling's
        restart as a fleet-lifetime delta."""
        while True:
            try:
                own = registry.snapshot()
                if metrics_spool is not None:
                    entries = await asyncio.to_thread(
                        obs_metrics.load_spool, metrics_spool)
                    entries = [(wid, s) for wid, s in entries
                               if wid != worker_id]
                    entries.append((worker_id, own))
                    snap = obs_slo.worker_labeled_snapshot(entries)
                else:
                    snap = own
                slo_engine.observe(snap)
            # one bad beat (a torn spool file mid-teardown, a foreign
            # snapshot shape) must not kill alerting for the process's
            # life: log, and the next tick retries
            # lint: broad-except-ok degrade-never-die heartbeat; the
            # failure is logged and the next tick retries
            except Exception as err:
                log.warning("slo evaluation tick failed: %s", err)
            await asyncio.sleep(slo_eval)

    async def _spool_writer() -> None:
        path = os.path.join(metrics_spool, f"worker-{worker_id}.json")
        while True:
            snap = registry.snapshot()
            try:
                await asyncio.to_thread(
                    obs_metrics.write_snapshot_file, path, snap)
            except OSError as err:
                # a failed heartbeat (ENOSPC, spool dir racing the
                # supervisor's teardown) must not kill the writer: the
                # next beat retries, and the loss is logged so a worker
                # going stale in the fleet view is diagnosable
                log.warning("metrics spool write failed: %s", err)
            await asyncio.sleep(_SPOOL_INTERVAL)

    async def _on_startup(app: web.Application) -> None:
        lag_monitor.start(asyncio.get_running_loop())
        if metrics_spool is not None:
            spool_task["task"] = asyncio.ensure_future(_spool_writer())
        if slo_engine is not None:
            slo_task["task"] = asyncio.ensure_future(_slo_ticker())

    async def _on_cleanup(app: web.Application) -> None:
        lag_monitor.stop()
        for holder in (spool_task, slo_task):
            task = holder["task"]
            if task is not None:
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
                holder["task"] = None

    app = web.Application(middlewares=[access_log])
    app[PROFILER_KEY] = profiler
    app[HEALTH_KEY] = health_state
    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    # registered before the catch-all: these endpoints shadow objects
    # literally named "scrub/status", "metrics", "stats", "healthz",
    # "alerts", "debug/traces" (documented deviation — the reference's
    # gateway has no non-object routes at all)
    app.router.add_get("/scrub/status", handle_scrub_status)
    app.router.add_get("/alerts", handle_alerts)
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_get("/stats", handle_stats)
    app.router.add_get("/healthz", handle_healthz)
    app.router.add_get("/debug/traces", handle_debug_traces)
    app.router.add_get("/{path:.*}", handle_get)  # also serves HEAD
    app.router.add_put("/{path:.*}", handle_put)
    return app


async def serve(cluster: Cluster, host: str = "127.0.0.1",
                port: int = 8000,
                max_put_bytes: Optional[int] = None,
                max_concurrent_puts: int = DEFAULT_MAX_CONCURRENT_PUTS,
                min_put_rate: int = DEFAULT_MIN_PUT_RATE,
                max_concurrent_gets: int = DEFAULT_MAX_CONCURRENT_GETS,
                workers: Optional[int] = None,
                reuse_port: bool = False,
                on_ready: Optional[Callable[[int], None]] = None,
                metrics_spool: Optional[str] = None,
                health_state: Optional[HealthState] = None
                ) -> None:
    """Bind and serve until cancelled (ctrl-c graceful shutdown,
    main.rs:474-485).

    ``workers`` (None = the ``tunables.gateway_workers`` env default,
    normally 1) > 1 delegates to gateway/workers.py: N pre-forked
    SO_REUSEPORT processes, each running this single-process serve with
    ``reuse_port=True``.  ``on_ready`` fires with the bound port once
    the listener accepts connections (the worker readiness handshake;
    also handy for tests)."""
    from chunky_bits_tpu_torch.cluster.tunables import (gateway_workers,
                                                        sanitize_enabled)

    if workers is None:
        workers = gateway_workers()
    if workers > 1:
        from chunky_bits_tpu_torch.gateway.workers import serve_workers

        await serve_workers(
            cluster, host=host, port=port, workers=workers,
            max_put_bytes=max_put_bytes,
            max_concurrent_puts=max_concurrent_puts,
            min_put_rate=min_put_rate,
            max_concurrent_gets=max_concurrent_gets,
            on_ready=on_ready)
        return

    if sanitize_enabled():
        # opt-in runtime concurrency sanitizer: instrument the serving
        # loop (stall watchdog + task registry), read here, at the one
        # moment the gateway's loop is known
        from chunky_bits_tpu_torch.analysis.sanitizer import get_monitor

        get_monitor().instrument_loop(asyncio.get_running_loop())
    # continuous scrub rides the serving loop when the cluster's
    # `scrub_bytes_per_sec` tunable asks for it (cluster/scrub.py; off =
    # no daemon object).  Single-process serve only: a pre-forked fleet
    # would run N identical namespace walks, so its workers answer
    # /scrub/status with enabled: false
    scrub = None
    if not reuse_port:
        from chunky_bits_tpu_torch.cluster.scrub import maybe_build

        scrub = maybe_build(cluster)
    runner = web.AppRunner(
        make_app(cluster, max_put_bytes=max_put_bytes,
                 max_concurrent_puts=max_concurrent_puts,
                 min_put_rate=min_put_rate,
                 max_concurrent_gets=max_concurrent_gets,
                 scrub=scrub, metrics_spool=metrics_spool,
                 health_state=health_state))
    await runner.setup()
    site = web.TCPSite(runner, host, port, reuse_port=reuse_port)
    await site.start()
    if scrub is not None:
        scrub.start()
    bound_port = port
    server = getattr(site, "_server", None)
    if server is not None and server.sockets:
        bound_port = server.sockets[0].getsockname()[1]
    print(f"listening on http://{host}:{bound_port}", flush=True)
    if on_ready is not None:
        on_ready(bound_port)
    try:
        while True:
            await asyncio.sleep(3600)
    # ctrl-c or cancel is the shutdown signal of the serve park: the
    # finally's graceful teardown runs before exit
    # lint: cancel-safety-ok ctrl-c/cancel IS the shutdown signal for
    # the serve park; swallowing it hands control to the finally's
    # graceful teardown (scrub stop + runner cleanup) before exit
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        if scrub is not None:
            await scrub.stop()
        await runner.cleanup()
