"""Cluster-wide knobs and the one home for ``CHUNKY_BITS_TORCH_*`` reads
(the port of ``chunky_bits_tpu/cluster/tunables.py``).

``Tunables`` is a cluster YAML's ``tunables:`` mapping, as in the JAX
package (src/cluster/tunables.rs:52-95 plus that package's extensions):
``on_conflict``, ``https_only``, ``user_agent``, the erasure ``backend``,
the host and read-path knobs, and the serving plane's opt-in parts
(``slo_eval_s`` with the ``slo:`` objectives, and the ``qos:`` tenant
table).  YAML wins; an environment variable supplies each default.
``backend`` keeps the string as written, so a YAML naming the JAX
package's backends round-trips; the names resolve in
``ops.backend.canonical_backend_name``.  The ``slo:`` and ``qos:``
mappings are validated loudly at load against ``obs/slo.py`` and
``cluster/qos.py``.  The gateway's deployment knobs (worker count,
sendfile) and the multi-host coordinator are environment-only, as in the
JAX package.

The environment accessors are stand-alone copies of the JAX package's,
plus ``virtual_devices`` (the port's stand-in for the forced host device
count).  The port reads only its own prefix, so a process that configures
the JAX package through ``CHUNKY_BITS_TPU_*`` leaves the port as it is.
Callers read a knob at the moment it takes effect, never at import time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

from chunky_bits_tpu_torch.errors import SerdeError

if TYPE_CHECKING:
    from chunky_bits_tpu_torch.file.location import LocationContext

#: prefix of every environment variable the port reads
ENV_PREFIX = "CHUNKY_BITS_TORCH_"

#: default erasure backend name (``numpy``, ``torch``, ``native[:N]`` or
#: ``cuda``)
BACKEND_ENV = ENV_PREFIX + "BACKEND"

#: "1" hashes shards on the card inside the encode dispatch
DEVICE_SHA_ENV = ENV_PREFIX + "DEVICE_SHA"

#: flag: the field-multiplexed GF(2^8) kernel at the geometries it takes
#: (``gf_kernel.packed_geometry_ok``); off by default, as in the JAX package
PACKED_KERNEL_ENV = ENV_PREFIX + "PACKED_KERNEL"

#: host compute worker count of the shared host pipeline (0/unset = one
#: per core)
HOST_THREADS_ENV = ENV_PREFIX + "HOST_THREADS"

#: flag: the ``native`` backend runs GF(2^8) matrix applies as a
#: scheduled program of wide XORs over bit-planes (ops/xor_schedule.py +
#: ``cb_xor_exec`` in csrc/gf256.cpp) instead of per-byte table kernels.
#: Byte-identical either way; off by default, as in the JAX package.  Read
#: at the first dispatch of each ``NativeBackend``
XOR_SCHEDULE_ENV = ENV_PREFIX + "XOR_SCHEDULE"

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

#: per-loop chunk read-cache budget in bytes (file/chunk_cache.py);
#: 0/unset = no cache.  YAML ``cache_bytes`` wins
CACHE_BYTES_ENV = ENV_PREFIX + "CACHE_BYTES"

#: slow-request tracing threshold in milliseconds (obs/tracing.py, the
#: gateway's ``/debug/traces``); 0/unset = tracing off.  YAML
#: ``trace_slow_ms`` wins
TRACE_SLOW_MS_ENV = ENV_PREFIX + "TRACE_SLOW_MS"

#: gateway worker-process count (gateway/workers.py): N > 1 pre-forks N
#: SO_REUSEPORT serving processes, each with its own loop, cluster,
#: CUDA context and chunk cache.  A deployment knob, env/CLI only; the
#: ``http-gateway --workers`` flag wins
GATEWAY_WORKERS_ENV = ENV_PREFIX + "GATEWAY_WORKERS"

#: flag, default on: the gateway streams a range inside one verified
#: local data chunk with ``loop.sendfile``; a falsy value sends every GET
#: through reassembly
GATEWAY_SENDFILE_ENV = ENV_PREFIX + "GATEWAY_SENDFILE"

#: hedged-read delay floor in milliseconds (cluster/health.py); 0/unset
#: = hedging off.  YAML ``hedge_ms`` wins
HEDGE_MS_ENV = ENV_PREFIX + "HEDGE_MS"

#: per-location retries of transient HTTP errors on the read fall-through
#: and the shard-write failover (default 1).  YAML ``read_retries`` wins
READ_RETRIES_ENV = ENV_PREFIX + "READ_RETRIES"

#: writer stagger: writer i waits this long for writer i-1's first
#: placement decision (the reference pins 100 ms, writer.rs:246)
STAGGER_SECONDS_ENV = ENV_PREFIX + "STAGGER_SECONDS"

#: continuous-scrub byte-rate bound (cluster/scrub.py): bytes per second
#: the scrub daemon may read and repair; 0/unset = no daemon.  YAML
#: ``scrub_bytes_per_sec`` wins
SCRUB_BYTES_PER_SEC_ENV = ENV_PREFIX + "SCRUB_BYTES_PER_SEC"

#: block-digest tree granularity in bytes (file/chunk.py BlockDigests);
#: 0/unset = off.  YAML ``repair_block_bytes`` wins
REPAIR_BLOCK_BYTES_ENV = ENV_PREFIX + "REPAIR_BLOCK_BYTES"

#: default erasure code for write profiles that do not pin ``code:``:
#: "rs" or "pm-msr".  A default, not a force: a profile whose geometry
#: cannot run pm-msr stays rs (cluster/profile.py)
CODE_ENV = ENV_PREFIX + "CODE"

#: fleet-wide metadata-store kind override for ``type: path`` stores:
#: ``meta-log`` (cluster/meta_log.py)
METADATA_KIND_ENV = ENV_PREFIX + "METADATA_KIND"

#: SLO engine evaluation cadence in seconds (obs/slo.py, the gateway's
#: ``/alerts``): > 0 runs the windowed burn-rate engine every this many
#: seconds; 0/unset = no engine, no ring, no ticker.  YAML ``slo_eval_s``
#: wins.  Read at gateway app build
SLO_EVAL_S_ENV = ENV_PREFIX + "SLO_EVAL_S"

#: flag: multi-tenant QoS admission (cluster/qos.py, gateway/qos.py) in
#: front of GET bodies and PUT ingest.  YAML ``qos.enabled`` wins when
#: present.  Read at gateway app build
QOS_ENV = ENV_PREFIX + "QOS"

#: ``host:port`` of the multi-host coordinator (parallel/multihost.py):
#: ``init_multihost()`` with no arguments joins the process group there,
#: as process ``$CHUNKY_BITS_TORCH_PROCESS_ID`` of
#: ``$CHUNKY_BITS_TORCH_NUM_PROCESSES``
COORDINATOR_ADDRESS_ENV = ENV_PREFIX + "COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = ENV_PREFIX + "NUM_PROCESSES"
PROCESS_ID_ENV = ENV_PREFIX + "PROCESS_ID"

#: flag: the opt-in runtime concurrency sanitizer (analysis/sanitizer.py):
#: event-loop stall watchdog, task-leak registry, host-pipeline handoff
#: checks.  Off by default (a correctness tool, not a perf mode); read at
#: the activation points (HostPipeline construction, gateway serve), so
#: set it before the process builds its first pipeline or loop
SANITIZE_ENV = ENV_PREFIX + "SANITIZE"

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


def sanitize_enabled() -> bool:
    """True when ``$CHUNKY_BITS_TORCH_SANITIZE`` asks for the runtime
    concurrency sanitizer.  Callers gate both the instrumentation and
    the ``analysis.sanitizer`` import on this, so the off path never
    loads the instrumentation module (pinned by
    tests/test_torch_sanitizer.py)."""
    return env_flag(SANITIZE_ENV)


def xor_schedule_enabled(*, default: bool = False) -> bool:
    """True when ``$CHUNKY_BITS_TORCH_XOR_SCHEDULE`` asks the ``native``
    backend for the scheduled-XOR engine; parsed as a standard flag."""
    return env_flag(XOR_SCHEDULE_ENV, default=default)


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


def set_default_backend(name: str) -> None:
    """Make ``name`` the process's default erasure backend (the CLI's
    ``--backend``): a write of ``$CHUNKY_BITS_TORCH_BACKEND``, which
    ``ops.backend.canonical_backend_name`` reads at each resolution."""
    os.environ[BACKEND_ENV] = name


def environ_without(*names: str) -> dict:
    """A copy of this process's environment without ``names``: the
    environment of a child process that must see those knobs' defaults."""
    return {k: v for k, v in os.environ.items() if k not in names}


def env_seconds(name: str, *, default: float) -> float:
    """Duration env knob in seconds; unset or empty reads as ``default``.
    A malformed value raises ``ValueError``: a typo must fail loudly."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"bad ${name}={raw!r} (want seconds)") from None


def _lenient(name: str, parse, default, ok):
    """``parse($name)`` where ``ok`` holds, else ``default``: a perf knob
    can only tune, never crash, startup."""
    try:
        v = parse(os.environ.get(name, ""))
    except ValueError:
        return default
    return v if ok(v) else default


def erasure_code(*, default: str = "rs") -> str:
    """Requested default erasure code from ``$CHUNKY_BITS_TORCH_CODE``;
    an unknown value reads as ``default``.  Geometry compatibility is the
    caller's check (cluster/profile.py)."""
    from chunky_bits_tpu_torch.ops.backend import KNOWN_CODES

    raw = os.environ.get(CODE_ENV, "").strip()
    return raw if raw in KNOWN_CODES else default


def metadata_kind(*, default: str = "") -> str:
    """Requested fleet-wide metadata-store kind from
    ``$CHUNKY_BITS_TORCH_METADATA_KIND``: only ``meta-log`` is honoured,
    anything else reads as ``default`` ("" = no override)."""
    raw = os.environ.get(METADATA_KIND_ENV, "").strip()
    return raw if raw == "meta-log" else default


def stagger_seconds(*, default: float = 0.1) -> float:
    """Shard-writer stagger window (cluster/destination.py); the
    reference pins 100 ms (src/cluster/writer.rs:246)."""
    return _lenient(STAGGER_SECONDS_ENV, float, default, lambda v: v >= 0)


def hedge_ms(*, default: float = 0.0) -> float:
    """Env default of the ``hedge_ms`` tunable (0 = hedged reads off)."""
    return _lenient(HEDGE_MS_ENV, float, default, lambda v: v > 0)


def read_retries(*, default: int = 1) -> int:
    """Env default of the ``read_retries`` tunable; negative reads as the
    default."""
    return _lenient(READ_RETRIES_ENV, int, default, lambda v: v >= 0)


def scrub_bytes_per_sec(*, default: float = 0.0) -> float:
    """Env default of the ``scrub_bytes_per_sec`` tunable (0 = the scrub
    daemon stays off); malformed or negative reads as off."""
    return _lenient(SCRUB_BYTES_PER_SEC_ENV, float, default,
                    lambda v: v > 0)


def repair_block_bytes(*, default: int = 0) -> int:
    """Env default of the ``repair_block_bytes`` tunable (0 = no
    block-digest trees)."""
    return _lenient(REPAIR_BLOCK_BYTES_ENV, int, default, lambda v: v > 0)


def cache_bytes(*, default: int = 0) -> int:
    """Env default of the ``cache_bytes`` tunable (0 = no read cache);
    malformed or negative reads as off."""
    return _lenient(CACHE_BYTES_ENV, int, default, lambda v: v >= 0)


def trace_slow_ms(*, default: float = 0.0) -> float:
    """Env default of the ``trace_slow_ms`` tunable (0 = tracing off);
    malformed or negative reads as off."""
    return _lenient(TRACE_SLOW_MS_ENV, float, default, lambda v: v > 0)


def slo_eval_s(*, default: float = 0.0) -> float:
    """Env default of the ``slo_eval_s`` tunable (0 = the SLO engine stays
    off); malformed or negative reads as off."""
    return _lenient(SLO_EVAL_S_ENV, float, default, lambda v: v > 0)


def qos_enabled(*, default: bool = False) -> bool:
    """True when ``$CHUNKY_BITS_TORCH_QOS`` asks for multi-tenant QoS
    admission; the YAML ``qos.enabled`` wins when the mapping sets it."""
    return env_flag(QOS_ENV, default=default)


def coordinator() -> Optional[tuple[str, int, int]]:
    """``(address, num_processes, process_id)`` of the multi-host job
    named by ``$CHUNKY_BITS_TORCH_COORDINATOR_ADDRESS``,
    ``$CHUNKY_BITS_TORCH_NUM_PROCESSES`` and
    ``$CHUNKY_BITS_TORCH_PROCESS_ID``; None when no address is set.  With
    an address, a missing or malformed count or id raises ``ValueError``:
    a job that cannot say its size must not start."""
    address = os.environ.get(COORDINATOR_ADDRESS_ENV)
    if not address:
        return None
    try:
        return (address, int(os.environ[NUM_PROCESSES_ENV]),
                int(os.environ[PROCESS_ID_ENV]))
    except (KeyError, ValueError):
        raise ValueError(
            f"${COORDINATOR_ADDRESS_ENV} is set: ${NUM_PROCESSES_ENV} and "
            f"${PROCESS_ID_ENV} must name this process's place in the "
            "job") from None


def gateway_workers(*, default: int = 1) -> int:
    """Gateway worker-process count from
    ``$CHUNKY_BITS_TORCH_GATEWAY_WORKERS``; unset, malformed or
    non-positive reads as ``default`` (1 = one serving process).  Read at
    serve start; the CLI's ``--workers`` wins."""
    return _lenient(GATEWAY_WORKERS_ENV, int, default, lambda v: v > 0)


def gateway_sendfile(*, default: bool = True) -> bool:
    """True when the gateway may stream verified local chunks with
    ``loop.sendfile``; a falsy ``$CHUNKY_BITS_TORCH_GATEWAY_SENDFILE``
    forces reassembly (storage shared with outside writers that
    truncate, the same caveat as ``$CHUNKY_BITS_TORCH_NO_MMAP``).  Read
    at app build."""
    return env_flag(GATEWAY_SENDFILE_ENV, default=default)


#: the tunables parsed as numbers: (name, type, default factory); YAML
#: values must be >= 0
_NUMERIC = (
    ("host_threads", int, host_threads),
    ("hedge_ms", float, hedge_ms),
    ("read_retries", int, read_retries),
    ("scrub_bytes_per_sec", float, scrub_bytes_per_sec),
    ("repair_block_bytes", int, repair_block_bytes),
    ("cache_bytes", int, cache_bytes),
    ("trace_slow_ms", float, trace_slow_ms),
    ("slo_eval_s", float, slo_eval_s),
)


def _checked_mapping(name: str, raw: object, check) -> dict:
    """``raw`` (the YAML ``slo:`` or ``qos:`` mapping) validated by
    ``check`` (its module's loud ``from_obj``), as a plain dict."""
    try:
        check(raw)
    except ValueError as err:
        raise SerdeError(f"invalid {name} mapping: {err}") from err
    return dict(raw)


@dataclass
class Tunables:
    """A cluster's ``tunables:`` mapping; see the module docstring."""

    https_only: bool = False
    on_conflict: str = "ignore"
    user_agent: Optional[str] = None
    #: erasure backend name as written (None = the port's default)
    backend: Optional[str] = None
    #: host pipeline workers for this cluster's ingest and verify compute;
    #: 0 = the process-shared pipeline
    host_threads: int = field(default_factory=host_threads)
    #: hedged-read delay floor in ms (cluster/health.py); 0 = off
    hedge_ms: float = field(default_factory=hedge_ms)
    #: per-location transient-HTTP retry count
    read_retries: int = field(default_factory=read_retries)
    #: continuous-scrub byte-rate bound (cluster/scrub.py); 0 = off
    scrub_bytes_per_sec: float = field(default_factory=scrub_bytes_per_sec)
    #: block-digest tree granularity (file/chunk.py); 0 = off
    repair_block_bytes: int = field(default_factory=repair_block_bytes)
    #: per-loop chunk read-cache budget in bytes; 0 = no cache
    cache_bytes: int = field(default_factory=cache_bytes)
    #: slow-request tracing threshold in ms (the gateway); 0 = off
    trace_slow_ms: float = field(default_factory=trace_slow_ms)
    #: SLO engine evaluation cadence in seconds (obs/slo.py); 0 = off
    slo_eval_s: float = field(default_factory=slo_eval_s)
    #: SLO objective overrides (the YAML ``slo:`` mapping, validated
    #: against ``SloObjectives``); empty = the defaults
    slo: dict = field(default_factory=dict)
    #: multi-tenant QoS config (the YAML ``qos:`` mapping, validated
    #: against ``QosConfig``); empty = no named tenants, the scheduler on
    #: only through the env flag
    qos: dict = field(default_factory=dict)

    def is_device_backend(self) -> bool:
        """True when the erasure plane runs on the card (``cuda``,
        ``cuda:<spec>``, ``mesh``, the JAX package's ``jax`` names, and
        the default unless ``$CHUNKY_BITS_TORCH_BACKEND`` names a host
        backend): the regime where batching amortizes dispatches."""
        from chunky_bits_tpu_torch.ops.backend import canonical_backend_name

        name = canonical_backend_name(self.backend)
        return name == "cuda" or name.startswith("cuda:") or name == "mesh"

    def __post_init__(self) -> None:
        from chunky_bits_tpu_torch.file.location import (IGNORE, OVERWRITE,
                                                         LocationContext)

        if self.on_conflict not in (IGNORE, OVERWRITE):
            raise SerdeError(f"invalid on_conflict {self.on_conflict!r}")
        self._location_context = LocationContext(
            on_conflict=self.on_conflict, https_only=self.https_only,
            user_agent=self.user_agent, read_retries=self.read_retries)

    @classmethod
    def from_obj(cls, obj: object) -> "Tunables":
        if obj is None:
            return cls()
        if not isinstance(obj, dict):
            raise SerdeError("tunables must be a mapping")
        kwargs = {}
        for name, kind, _default in _NUMERIC:
            raw = obj.get(name)
            if raw is None:
                continue
            try:
                value = kind(raw)
            except (TypeError, ValueError) as err:
                raise SerdeError(f"invalid {name} {raw!r}") from err
            if value < 0:
                raise SerdeError(f"{name} must be >= 0, got {value}")
            kwargs[name] = value
        if obj.get("slo") is not None:
            # a typo'd objective must fail the cluster parse, not silently
            # never alert; obs/slo.py owns the field set
            from chunky_bits_tpu_torch.obs.slo import SloObjectives

            kwargs["slo"] = _checked_mapping("slo", obj["slo"],
                                             SloObjectives.from_obj)
        if obj.get("qos") is not None:
            # likewise a typo'd tenant table; cluster/qos.py owns the keys
            from chunky_bits_tpu_torch.cluster.qos import QosConfig

            kwargs["qos"] = _checked_mapping("qos", obj["qos"],
                                             QosConfig.from_obj)
        return cls(
            https_only=bool(obj.get("https_only", False)),
            on_conflict=obj.get("on_conflict", "ignore"),
            user_agent=obj.get("user_agent"),
            backend=obj.get("backend"),
            **kwargs,
        )

    def to_obj(self) -> dict:
        obj = {
            "https_only": self.https_only,
            "on_conflict": self.on_conflict,
            "user_agent": self.user_agent,
        }
        if self.backend is not None:
            obj["backend"] = self.backend
        for name, _kind, _default in _NUMERIC:
            value = getattr(self, name)
            if name == "read_retries" and value != 1 or (
                    name != "read_retries" and value > 0):
                obj[name] = value
        for name in ("slo", "qos"):
            if getattr(self, name):
                obj[name] = dict(getattr(self, name))
        return obj

    def location_context(self) -> "LocationContext":
        """The cluster's shared ``LocationContext`` (its health scoreboard
        is set by ``Cluster``)."""
        return self._location_context
