"""Uniform storage addressing (the port of
``chunky_bits_tpu/file/location.py``).

As the reference's ``Location`` (src/file/location.rs:61-68), an address
is ``Local{path, range}`` or ``Http{url, range}``, a plain string with an
optional ``(start,len)`` range prefix, plus the JAX package's packed
``slab:<root>/<name>`` addresses (a chunk inside a ``file/slab.py``
store) and its ``sim:<fabric>/<node>/<chunk>`` addresses (a chunk on a
simulated node of ``sim/fabric.py``, imported only when such a location is
touched).  The verbs: read (ranges, zero-extension), a streaming reader, a
zero-copy page-cache view (local and slab), write and streaming write
(conflict policy; local writes publish atomically, slab writes append
and commit one journal line), subfile write (content-addressed
children), delete (a slab extent is marked dead), exists and len.  Filesystem calls hop to threads; HTTP goes through one aiohttp
session per event loop (``LocationContext.http_session``), honouring
``https_only`` (plain http and redirects refused) and ``user_agent``.
The reference's HTTP ``file_len`` is ``todo!()`` (location.rs:394); here
it reads Content-Length from a HEAD.  Every read and write also reports
to the context's location-health scoreboard when a cluster set one
(cluster/health.py).
"""

from __future__ import annotations

import asyncio
import errno
import functools
import io
import os
import re
from dataclasses import dataclass, field, replace
from typing import Optional
from urllib.parse import quote, urlsplit, urlunsplit

from chunky_bits_tpu_torch.errors import (
    HttpStatusError,
    LocationError,
    LocationParseError,
    ShardError,
    WriteToRangeError,
)
from chunky_bits_tpu_torch.file.hashing import AnyHash
from chunky_bits_tpu_torch.file.profiler import Profiler
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils import clock as _clock
from chunky_bits_tpu_torch.utils import fsio as _fsio

OVERWRITE = "overwrite"
IGNORE = "ignore"


@dataclass(frozen=True)
class Range:
    """Byte range view over a location (src/file/location.rs:550-603)."""

    start: int = 0
    length: Optional[int] = None
    extend_zeros: bool = False

    def is_specified(self) -> bool:
        return self.start != 0 or self.length is not None

    def __str__(self) -> str:
        if self.length is not None and not self.extend_zeros:
            return f"({self.start},{self.length})"
        if self.length is not None and self.extend_zeros:
            return f"({self.start},0{self.length})"
        return f"({self.start},)"

    @staticmethod
    def from_str_prefix(s: str) -> tuple["Range", str]:
        """Split a leading ``(start,len)`` prefix off a location string; a
        length with a leading ``0`` marks zero-extension
        (location.rs:581-602)."""
        if s.startswith("("):
            inner, sep, suffix = s[1:].partition(")")
            if sep:
                left, comma, right = inner.partition(",")
                if comma:
                    try:
                        start = int(left)
                        length = int(right) if right else None
                    except ValueError:
                        return Range(), s
                    if right and (not right.lstrip("-").isdigit()):
                        return Range(), s
                    return (
                        Range(start, length, right.startswith("0")),
                        suffix,
                    )
        return Range(), s


class LocationContext:
    """Per-operation context: conflict policy, the HTTP client settings
    and sessions, an optional profiler and an optional location-health
    scoreboard (src/file/location.rs:447-510).

    ``health`` (a ``cluster.health.HealthScoreboard``, duck-typed to keep
    ``file/`` free of the cluster package) receives a completion record
    for every read, write and served page-cache view: the feed for
    latency-ranked ordering, the per-location breaker and the hedged-read
    delay.  ``read_retries`` bounds the per-location retries of transient
    HTTP errors in the read fall-through (file/file_part.py) and the
    shard-write failover (cluster/destination.py)."""

    def __init__(self, on_conflict: str = OVERWRITE,
                 profiler: Optional[Profiler] = None,
                 https_only: bool = False,
                 user_agent: Optional[str] = None,
                 read_retries: int = 1):
        if on_conflict not in (OVERWRITE, IGNORE):
            raise ValueError(f"invalid on_conflict {on_conflict!r}")
        self.on_conflict = on_conflict
        self.profiler = profiler
        self.https_only = https_only
        self.user_agent = user_agent
        self.read_retries = max(int(read_retries), 0)
        self.health = None  # set by Cluster.__init__ (one per cluster)
        self._sessions: dict[int, tuple] = {}

    def but_with(self, *, on_conflict: Optional[str] = None,
                 profiler: Optional[Profiler] = None) -> "LocationContext":
        cx = LocationContext(
            on_conflict=on_conflict or self.on_conflict,
            profiler=profiler if profiler is not None else self.profiler,
            https_only=self.https_only, user_agent=self.user_agent,
            read_retries=self.read_retries)
        cx.health = self.health  # one scoreboard per cluster
        cx._sessions = self._sessions  # share the connection pools
        return cx

    def http_session(self):
        """The aiohttp session of the running loop (loop-bound, cached).

        Entries hold a weakref of their loop, since the ``id()`` of a
        dead loop can be reused by a new one.  Each new session also
        primes an async generator whose finalizer closes it, so
        ``asyncio.run``'s ``shutdown_asyncgens`` closes the session while
        its loop is still alive even when nobody calls :meth:`aclose`."""
        import weakref

        import aiohttp

        loop = asyncio.get_running_loop()
        entry = self._sessions.get(id(loop))
        if entry is not None:
            loop_ref, sess = entry[0], entry[1]
            if loop_ref() is loop and not sess.closed:
                return sess
            del self._sessions[id(loop)]  # a dead or reused loop's
        headers = {}
        if self.user_agent:
            headers["User-Agent"] = self.user_agent
        sess = aiohttp.ClientSession(headers=headers)

        async def _closer():
            try:
                yield
            finally:
                if not sess.closed:
                    await sess.close()

        gen = _closer()
        # sweep the entries of dead loops (they cannot be closed anymore)
        for key, (ref, _s, _g, _p) in list(self._sessions.items()):
            if ref() is None:
                del self._sessions[key]
        # prime the generator so the loop finalizes it at shutdown; the
        # entry holds the strong reference (the loop's registry is weak)
        primer = asyncio.ensure_future(gen.__anext__())
        self._sessions[id(loop)] = (weakref.ref(loop), sess, gen, primer)
        return sess

    async def aclose(self) -> None:
        """Close the running loop's HTTP session, if it has one."""
        loop = asyncio.get_running_loop()
        entry = self._sessions.pop(id(loop), None)
        if entry is None:
            return
        _ref, sess, gen, primer = entry
        if not primer.done():
            primer.cancel()
        # retrieve the primer's outcome either way, so it never surfaces
        # as a task exception nobody retrieved
        try:
            # lint: unbounded-deadline-ok primer is done or was
            # cancelled two lines up — this await only retrieves
            # the already-settled outcome
            await primer
        except (asyncio.CancelledError, StopAsyncIteration):
            pass
        await gen.aclose()  # runs the closer's finally
        if not sess.closed:
            await sess.close()


_DEFAULT_CONTEXT = LocationContext()


def default_context() -> LocationContext:
    return _DEFAULT_CONTEXT


#: atomic local publication stages "<target>.tmp.<pid>.<8-hex>" and
#: replaces the target with it
_PUBLISH_TEMP_RE = re.compile(r"\.tmp\.\d+\.[0-9a-f]{8}$")


def publish_temp_name(target: str) -> str:
    """The staging path for an atomic publication of ``target``."""
    return f"{target}.tmp.{os.getpid()}.{os.urandom(4).hex()}"


def is_publish_temp(name: str) -> bool:
    """True when ``name`` is an atomic-publication temp file: invisible to
    readers until renamed, so an old one is a crashed writer's leak."""
    return _PUBLISH_TEMP_RE.search(name) is not None


async def _publish_atomically(target: str, write_body) -> int:
    """Local write published atomically where possible
    (``write_body(path) -> int`` lands the bytes at the given path).

    Regular-file targets are written to a sibling temp file and replaced
    in, so a concurrent reader (page-cache views from ``read_view``
    included) never sees a torn or truncated file.  Durability follows
    the filesystem's rename (flush, no fsync, as the reference).  Symlinks
    and special files are written directly, and so is a target whose
    directory refuses the temp file (EACCES/EPERM/EROFS).  An existing
    file's permission bits carry over.  The chmod+replace and the temp
    reaping stay synchronous: a suspension point between the write and
    the rename would let a cancellation race the reap against the swap."""
    direct, mode = await asyncio.to_thread(_publish_precheck, target)
    if direct:
        return await write_body(target)
    tmp = publish_temp_name(target)
    try:
        total = await write_body(tmp)
        if mode is not None:
            # lint: async-blocking-ok bounded local chmod on the
            # staging file; sync keeps publication atomic under
            # cancellation (see docstring)
            os.chmod(tmp, mode)
        _fsio.replace(tmp, target)
        return total
    except OSError as err:
        created = _reap_publish_temp(tmp)
        if not created and err.errno in (errno.EACCES, errno.EPERM,
                                         errno.EROFS):
            return await write_body(target)
        raise
    except BaseException:
        _reap_publish_temp(tmp)
        raise


def _publish_precheck(target: str) -> tuple[bool, Optional[int]]:
    """(write directly?, mode to keep) for one publication."""
    if os.path.islink(target) or (
            os.path.exists(target) and not os.path.isfile(target)):
        return True, None
    try:
        return False, os.stat(target).st_mode & 0o7777
    except OSError:
        return False, None


def _reap_publish_temp(tmp: str) -> bool:
    """Remove a staging temp; True when it existed."""
    created = os.path.exists(tmp)
    try:
        _fsio.unlink(tmp)
    except OSError:
        pass
    return created


async def _atomic_publish(target: str, data) -> None:
    def _write(path: str) -> int:
        with _fsio.open(path, "wb") as f:
            f.write(data)
            f.flush()
        return len(data)

    await _publish_atomically(
        target, lambda path: asyncio.to_thread(_write, path))


async def _drain(reader) -> bytes:
    """A reader's whole body (chunk payloads are bounded by the profile's
    chunk size)."""
    chunks: list[bytes] = []
    while True:
        data = await reader.read(1 << 20)
        if not data:
            break
        chunks.append(data)
    return b"".join(chunks)


async def _atomic_publish_stream(reader, target: str) -> int:
    return await _publish_atomically(
        target, lambda path: aio.copy_reader_to_file(reader, path))


class _HttpBodyReader:
    """An aiohttp response body as an AsyncByteReader; the response is
    released at EOF or on close()."""

    def __init__(self, resp):
        self._resp = resp

    async def read(self, n: int = -1) -> bytes:
        if self._resp is None:
            return b""
        try:
            if n < 0:
                data = await self._resp.content.read()
            else:
                data = await self._resp.content.read(n)
        except Exception as err:
            # a failure mid-body is a LocationError, so the read
            # fall-through moves on to the next replica
            self._resp.close()
            self._resp = None
            raise LocationError(f"http body read failed: {err}") from err
        if not data:
            self._resp.release()
            self._resp = None
        return data

    async def close(self) -> None:
        if self._resp is not None:
            self._resp.release()
            self._resp = None


class _ProfiledReader:
    """Counts streamed bytes and logs exactly one profiler entry when the
    stream ends: EOF, error, or early close."""

    def __init__(self, base, profiler: Profiler, location: "Location",
                 start: float):
        self._base = base
        self._profiler = profiler
        self._location = location
        self._start = start
        self._total = 0
        self._logged = False

    def _log(self, ok: bool, err: Optional[str] = None) -> None:
        if not self._logged:
            self._logged = True
            self._profiler.log_read(ok, err, self._location, self._total,
                                    self._start)

    async def read(self, n: int = -1) -> bytes:
        try:
            data = await self._base.read(n)
        except Exception as err:
            self._log(False, str(err))
            raise
        if data:
            self._total += len(data)
        else:
            self._log(True)
        return data

    async def close(self) -> None:
        self._log(True)
        await aio.close_reader(self._base)


@dataclass(frozen=True, order=True)
class Location:
    """A storage address; value semantics, string serde."""

    kind: str  # "local" | "http" | "slab" | "sim"
    target: str  # filesystem path, full URL, slab <root>/<name> or
    #            sim <fabric>/<node>/<chunk>
    range: Range = field(default_factory=Range)

    # ---- construction / parsing ----

    @staticmethod
    def parse(s: str) -> "Location":
        rng, rest = Range.from_str_prefix(s)
        if rest.startswith("http://") or rest.startswith("https://"):
            if not urlsplit(rest).netloc:
                raise LocationParseError(f"invalid http url: {rest!r}")
            return Location("http", rest, rng)
        if rest.startswith("file://"):
            path = urlsplit(rest).path
            if not path.startswith("/"):
                raise LocationParseError("file:// path must be absolute")
            return Location("local", path, rng)
        if rest.startswith("slab:"):
            # packed slab store address (file/slab.py): the path names
            # <store root>/<chunk name>
            path = rest[len("slab:"):]
            if not path:
                raise LocationParseError("empty slab location")
            if "://" in path.split("/")[0]:
                raise LocationParseError(
                    f"invalid slab location: {rest!r}")
            return Location("slab", path, rng)
        if rest.startswith("sim:"):
            # simulated storage node (sim/fabric.py): the path names
            # <fabric>/<node>[/<chunk>]; the bytes live in the in-process
            # fabric registry, resolved lazily as slab: is
            path = rest[len("sim:"):]
            if not path:
                raise LocationParseError("empty sim location")
            return Location("sim", path, rng)
        if "://" in rest.split("/")[0]:
            raise LocationParseError(f"invalid location scheme: {rest!r}")
        if not rest:
            raise LocationParseError("empty location")
        return Location("local", rest, rng)

    @staticmethod
    def local(path: str, rng: Optional[Range] = None) -> "Location":
        return Location("local", str(path), rng or Range())

    @staticmethod
    def slab(path: str, rng: Optional[Range] = None) -> "Location":
        return Location("slab", str(path), rng or Range())

    @staticmethod
    def sim(path: str, rng: Optional[Range] = None) -> "Location":
        return Location("sim", str(path), rng or Range())

    @staticmethod
    def http(url: str, rng: Optional[Range] = None) -> "Location":
        if not (url.startswith("http://") or url.startswith("https://")):
            raise LocationParseError(f"not an http url: {url!r}")
        return Location("http", url, rng or Range())

    def __str__(self) -> str:
        prefix = "slab:" if self.is_slab() else \
            "sim:" if self.is_sim() else ""
        if self.range.is_specified():
            return f"{self.range}{prefix}{self.target}"
        return f"{prefix}{self.target}"

    def is_http(self) -> bool:
        return self.kind == "http"

    def is_local(self) -> bool:
        return self.kind == "local"

    def is_slab(self) -> bool:
        return self.kind == "slab"

    def is_sim(self) -> bool:
        return self.kind == "sim"

    def with_range(self, rng: Range) -> "Location":
        return replace(self, range=rng)

    # ---- slab addressing (file/slab.py) ----

    def _slab_parts(self) -> tuple[str, str]:
        """(store root, chunk name) of a slab chunk address."""
        root, name = os.path.split(self.target.rstrip("/"))
        if not root or not name:
            raise LocationError(
                f"slab location {self.target!r} names a store root, "
                "not a chunk")
        return root, name

    def _slab_store(self):
        from chunky_bits_tpu_torch.file import slab

        return slab.get_store(self._slab_parts()[0])

    # ---- sim addressing (sim/fabric.py) ----

    def _sim_node(self) -> tuple[object, str]:
        """(simulated node, chunk name) of a sim chunk address.  The
        import runs only for sim locations, so production paths never
        load the simulator (tests/test_torch_sim.py pins it)."""
        # lint: sim-purity-ok lazy import only on the sim: address branch
        from chunky_bits_tpu_torch.sim import fabric as sim_fabric

        return sim_fabric.resolve(self.target)

    def slab_extent(self) -> Optional[tuple[str, int, int]]:
        """(slab file path, offset, length) of a live packed chunk, or
        None (not a slab location, or no such chunk).  Synchronous: it may
        read the store's journal, so callers run it off the loop."""
        if not self.is_slab():
            return None
        try:
            return self._slab_store().extent_path(self._slab_parts()[1])
        except (OSError, LocationError):
            return None

    # ---- hierarchy (src/file/location.rs:407-436) ----

    def child(self, name: str) -> "Location":
        if not self.is_http():
            return Location(self.kind, os.path.join(self.target, name))
        parts = urlsplit(self.target)
        path = parts.path.rstrip("/") + "/" + quote(name, safe="")
        return Location("http", urlunsplit(parts._replace(path=path)))

    def is_child_of(self, other: "Location") -> bool:
        if self.range.is_specified() or self.kind != other.kind:
            return False
        if not self.is_http():
            parent = os.path.dirname(self.target)
            return parent == other.target.rstrip("/") \
                or parent == other.target
        left, right = urlsplit(self.target), urlsplit(other.target)
        if (left.scheme, left.netloc) != (right.scheme, right.netloc):
            return False
        parent = left.path.rsplit("/", 1)[0]
        return parent == right.path.rstrip("/") or parent == right.path

    def is_parent_of(self, other: "Location") -> bool:
        return other.is_child_of(self)

    # ---- https_only (src/cluster/tunables.rs:25-32) ----

    def _check_scheme(self, cx: LocationContext) -> None:
        """Under ``https_only`` every network verb refuses a plain-http
        target, as the reference's https-only client does."""
        if cx.https_only and self.target.startswith("http://"):
            raise LocationError(
                f"https_only is set: refusing plain-http location "
                f"{self.target}")

    def _redirect_kwargs(self, cx: LocationContext) -> dict:
        """Under ``https_only`` redirects are not followed: a replayed
        PUT body could otherwise travel a plain-http hop."""
        return {"allow_redirects": False} if cx.https_only else {}

    def _check_redirect(self, cx: LocationContext, resp) -> None:
        """Refuse a 3xx answer under ``https_only`` (without it aiohttp
        has already followed the redirect)."""
        if cx.https_only and 300 <= resp.status < 400:
            resp.release()
            raise LocationError(
                f"https_only is set: refusing redirect ({resp.status}) "
                f"from {self.target}")

    def _check_response_hops(self, cx: LocationContext, resp) -> None:
        """For a GET, before its body is read: refuse a response whose
        redirect hops or final URL travelled plain http."""
        if not cx.https_only:
            return
        for r in (*resp.history, resp):
            if r.url.scheme == "http":
                resp.release()
                raise LocationError(
                    f"https_only is set: response for {self.target} "
                    f"travelled plain http via {r.url}")

    # ---- read path ----

    async def reader(self, cx: Optional[LocationContext] = None
                     ) -> aio.AsyncByteReader:
        """A streaming reader honoring the range
        (src/file/location.rs:115-183); with a profiler, one entry per
        stream at EOF, close or error."""
        cx = cx or default_context()
        start = _clock.monotonic()
        try:
            base = await self._open_reader(cx)
        except LocationError as err:
            # a failed open: one health sample and one profiler entry
            if cx.health is not None:
                cx.health.record(self, False, _clock.monotonic() - start)
            if cx.profiler is not None:
                cx.profiler.log_read(False, str(err), self, 0, start)
            raise
        if cx.health is not None:
            # the scoreboard times the open (time to first byte): how long
            # the stream runs depends on its consumer, not on the node
            cx.health.record(self, True, _clock.monotonic() - start)
        if cx.profiler is None:
            return base
        return _ProfiledReader(base, cx.profiler, self, start)

    async def _open_reader(self, cx: LocationContext
                           ) -> aio.AsyncByteReader:
        rng = self.range
        if self.is_http():
            return await self._open_http_reader(cx)
        if self.is_slab():
            return await self._open_slab_reader()
        if self.is_sim():
            return await self._open_sim_reader()

        def _open_local():
            f = open(self.target, "rb")
            try:
                if rng.start:
                    f.seek(rng.start)
            except BaseException:
                f.close()
                raise
            return f

        try:
            f = await aio.open_in_thread(_open_local, lambda h: h.close())
        except OSError as err:
            raise LocationError(str(err)) from err
        base = aio.FileReader(self.target, fileobj=f)
        if rng.length is None:
            return base
        if rng.extend_zeros:
            return aio.ZeroExtendReader(base, rng.length)
        return aio.TakeReader(base, rng.length)

    async def _open_slab_reader(self) -> aio.AsyncByteReader:
        """One indexed open and seek into the slab file, bounded by the
        extent: a short range reads short, as a local file that ends
        early does."""
        rng = self.range
        if rng.start < 0 or (rng.length is not None and rng.length < 0):
            raise LocationError(f"negative range {rng} on slab location")
        root, name = self._slab_parts()
        store = self._slab_store()

        def _open():
            ext = store.lookup(name)
            if ext is None:
                raise FileNotFoundError(
                    f"no live chunk {name!r} in slab store {root}")
            f = open(store.slab_path(ext.slab), "rb")
            try:
                f.seek(ext.offset + rng.start)
            except BaseException:
                f.close()
                raise
            return f, ext

        try:
            # a scrub restart or a hedge loser cancelled mid-open must
            # not orphan the slab handle
            f, ext = await aio.open_in_thread(_open, lambda r: r[0].close())
        except OSError as err:
            raise LocationError(str(err)) from err
        base = aio.FileReader(store.slab_path(ext.slab), fileobj=f)
        avail = max(ext.length - rng.start, 0)
        if rng.length is None:
            return aio.TakeReader(base, avail)
        if rng.extend_zeros:
            return aio.ZeroExtendReader(
                aio.TakeReader(base, min(avail, rng.length)), rng.length)
        return aio.TakeReader(base, min(rng.length, avail))

    async def _open_sim_reader(self) -> aio.AsyncByteReader:
        """The fabric applies its latency, fault and bandwidth models and
        returns the (ranged) payload; a short range reads short and
        ``extend_zeros`` pads, as on a local file."""
        rng = self.range
        if rng.start < 0 or (rng.length is not None and rng.length < 0):
            raise LocationError(f"negative range {rng} on sim location")
        node, name = self._sim_node()
        base = aio.BytesReader(await node.read(name, rng.start, rng.length))
        if rng.length is not None and rng.extend_zeros:
            return aio.ZeroExtendReader(base, rng.length)
        return base

    async def _open_http_reader(self, cx: LocationContext
                                ) -> aio.AsyncByteReader:
        """A ranged GET: 206 wanted for a range, 200 for the whole."""
        rng = self.range
        self._check_scheme(cx)
        headers = {}
        if rng.is_specified():
            if rng.length is not None:
                headers["Range"] = \
                    f"bytes={rng.start}-{rng.start + rng.length - 1}"
            else:
                headers["Range"] = f"bytes={rng.start}-"
        sess = cx.http_session()
        try:
            resp = await sess.get(self.target, headers=headers,
                                  **self._redirect_kwargs(cx))
        except Exception as err:
            raise LocationError(f"http get failed: {err}") from err
        self._check_redirect(cx, resp)
        self._check_response_hops(cx, resp)
        want = 206 if rng.is_specified() else 200
        if resp.status != want:
            resp.release()
            raise HttpStatusError(resp.status, self.target)
        base = _HttpBodyReader(resp)
        if rng.length is None:
            return base
        if rng.extend_zeros:
            return aio.ZeroExtendReader(base, rng.length)
        return aio.TakeReader(base, rng.length)

    async def read(self, cx: Optional[LocationContext] = None) -> bytes:
        """Read the full (ranged) content; profiler-hooked
        (src/file/location.rs:95-113)."""
        cx = cx or default_context()
        start = _clock.monotonic()
        if cx.health is not None:
            cx.health.begin(self)
        try:
            reader = await self._open_reader(cx)
            try:
                chunks = []
                while True:
                    data = await reader.read(1 << 20)
                    if not data:
                        break
                    chunks.append(data)
                out = b"".join(chunks)
            finally:
                # EOF does not release the file: close it, or every
                # whole-buffer read leaks an fd
                await aio.close_reader(reader)
        except LocationError as err:
            if cx.health is not None:
                cx.health.finish(self, False, _clock.monotonic() - start)
            if cx.profiler is not None:
                cx.profiler.log_read(False, str(err), self, 0, start)
            raise
        except BaseException:
            # cancellation (a hedge loser) or another failure: close the
            # in-flight count without a sample, since a cancelled racer
            # says nothing about the node
            if cx.health is not None:
                cx.health.finish(self, None, None)
            raise
        if cx.health is not None:
            cx.health.finish(self, True, _clock.monotonic() - start)
        if cx.profiler is not None:
            cx.profiler.log_read(True, None, self, len(out), start)
        return out

    async def read_view(self, cx: Optional[LocationContext] = None
                        ) -> Optional[memoryview]:
        """Zero-copy page-cache view of the (optionally ranged) file, or
        ``None`` where the fast path does not apply: a non-local target,
        an active profiler
        (which must see the generic read), ``$CHUNKY_BITS_TORCH_NO_MMAP``,
        a range reaching past the end (the generic path owns short-read
        and zero-extension semantics), or an unmappable file.

        The read-only view keeps its map alive for its own lifetime.
        Chunk files are published by rename, so a re-write of the same
        location never invalidates a view already taken; a file truncated
        by an outside writer can still SIGBUS a held view."""
        mapper = self.read_view_mapper(cx)
        if mapper is None:
            return None
        return await asyncio.to_thread(mapper)

    def read_view_mapper(self, cx: Optional[LocationContext] = None):
        """The synchronous mapper behind :meth:`read_view`, or ``None``
        when the zero-copy path does not apply; a caller already in a
        worker thread runs it there and fuses its own work (hash
        verification) into the same hop."""
        cx = cx or default_context()
        if (not (self.is_local() or self.is_slab())
                or cx.profiler is not None or aio.mmap_opted_out()):
            return None
        rng = self.range
        health = cx.health  # thread-safe scoreboard; _map runs off-loop
        if self.is_slab():
            try:
                name = self._slab_parts()[1]
            except LocationError:
                return None
            store = self._slab_store()

            def _map_slab() -> Optional[memoryview]:
                t0 = _clock.monotonic()
                view = store.map_view(name, rng.start or 0, rng.length)
                if view is not None and health is not None:
                    health.record(self, True, _clock.monotonic() - t0)
                return view

            return _map_slab

        def _map() -> Optional[memoryview]:
            import mmap

            t0 = _clock.monotonic()
            try:
                with open(self.target, "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except (OSError, ValueError, io.UnsupportedOperation):
                return None
            start = rng.start or 0
            end = len(mm) if rng.length is None else start + rng.length
            if (start < 0 or (rng.length is not None and rng.length < 0)
                    or end > len(mm) or start > len(mm)):
                # negative or short ranges: the generic path owns them
                mm.close()
                return None
            if health is not None:
                # only a served view is a sample: a None above means "the
                # fast path does not apply", and the generic read records
                health.record(self, True, _clock.monotonic() - t0)
            return memoryview(mm)[start:end]

        return _map

    # ---- write path ----

    async def write(self, data: bytes,
                    cx: Optional[LocationContext] = None) -> None:
        """Whole-buffer write with the conflict policy, published
        atomically on a local target; profiler-hooked
        (src/file/location.rs:185-244)."""
        cx = cx or default_context()
        if self.range.is_specified():
            raise WriteToRangeError()
        start = _clock.monotonic()
        if cx.health is not None:
            cx.health.begin(self)
        try:
            if cx.on_conflict == IGNORE and await self.file_exists(cx):
                pass
            elif self.is_slab():
                await self._slab_append(data)
            elif self.is_sim():
                node, name = self._sim_node()
                await node.write(name, data)
            elif self.is_local():
                try:
                    await _atomic_publish(self.target, data)
                except OSError as err:
                    raise LocationError(str(err)) from err
            else:
                await self._http_send("put", cx, data=data)
        except LocationError as err:
            if cx.health is not None:
                cx.health.finish(self, False, _clock.monotonic() - start)
            if cx.profiler is not None:
                cx.profiler.log_write(False, str(err), self, len(data), start)
            raise
        except BaseException:
            if cx.health is not None:
                cx.health.finish(self, None, None)  # cancelled: no verdict
            raise
        if cx.health is not None:
            cx.health.finish(self, True, _clock.monotonic() - start)
        if cx.profiler is not None:
            cx.profiler.log_write(True, None, self, len(data), start)

    async def write_from_reader(self, reader: aio.AsyncByteReader,
                                cx: Optional[LocationContext] = None) -> int:
        """Streaming write of a reader's bytes: published atomically on a
        local target, a chunked PUT of 1 MiB pieces to an HTTP one
        (src/file/location.rs:246-309); returns the bytes written.
        Profiler- and health-hooked like ``write``."""
        cx = cx or default_context()
        if self.range.is_specified():
            raise WriteToRangeError()
        if cx.on_conflict == IGNORE and await self.file_exists(cx):
            return 0
        start = _clock.monotonic()
        # count on the reader side, so a stream that fails midway still
        # profiles its partial progress
        counted = aio.CountingReader(reader)
        if cx.health is not None:
            cx.health.begin(self)
        try:
            if self.is_slab():
                # the journal commits (name -> extent) in one record, so
                # the whole body must be known before publication
                payload = await _drain(counted)
                await self._slab_append(payload)
                total = len(payload)
            elif self.is_sim():
                # one fabric publication per chunk, as on a slab
                payload = await _drain(counted)
                node, name = self._sim_node()
                await node.write(name, payload)
                total = len(payload)
            elif self.is_local():
                try:
                    total = await _atomic_publish_stream(counted,
                                                         self.target)
                except OSError as err:
                    raise LocationError(str(err)) from err
            else:
                total = await self._http_put_stream(counted, cx)
        except LocationError as err:
            if cx.health is not None:
                cx.health.finish(self, False, _clock.monotonic() - start)
            if cx.profiler is not None:
                cx.profiler.log_write(False, str(err), self, counted.total,
                                      start)
            raise
        except BaseException:
            if cx.health is not None:
                cx.health.finish(self, None, None)  # cancelled: no verdict
            raise
        if cx.health is not None:
            cx.health.finish(self, True, _clock.monotonic() - start)
        if cx.profiler is not None:
            cx.profiler.log_write(True, None, self, total, start)
        return total

    async def _slab_append(self, data) -> None:
        """Packed publication: slab append and journal commit
        (file/slab.py), the slab's counterpart of the rename above."""
        name = self._slab_parts()[1]
        try:
            await asyncio.to_thread(self._slab_store().append, name, data)
        except OSError as err:
            raise LocationError(str(err)) from err

    async def _http_put_stream(self, reader: aio.AsyncByteReader,
                               cx: LocationContext) -> int:
        total = 0

        async def gen():
            nonlocal total
            while True:
                data = await reader.read(1 << 20)
                if not data:
                    break
                total += len(data)
                yield data

        await self._http_send("put", cx, data=gen())
        return total

    async def _http_send(self, method: str, cx: LocationContext,
                         **kwargs):
        """One PUT, DELETE or HEAD; a status of 400 and above raises
        ``HttpStatusError`` (the transient ones are retried by the
        callers), except for HEAD, whose status the caller reads."""
        self._check_scheme(cx)
        sess = cx.http_session()
        try:
            resp = await getattr(sess, method)(
                self.target, **kwargs, **self._redirect_kwargs(cx))
            resp.release()
        except Exception as err:
            raise LocationError(f"http {method} failed: {err}") from err
        self._check_redirect(cx, resp)
        if method != "head" and resp.status >= 400:
            raise HttpStatusError(resp.status, self.target)
        return resp

    async def write_subfile(self, name: str, data: bytes,
                            cx: Optional[LocationContext] = None
                            ) -> "Location":
        """Write a named child (a content-addressed chunk) under this
        location and return it (src/file/location.rs:311-343)."""
        target = self.child(name)
        try:
            await target.write(data, cx)
        except LocationError as err:
            raise ShardError(str(err), location=target) from err
        return target

    # ---- management ----

    async def delete(self, cx: Optional[LocationContext] = None) -> None:
        if self.is_http():
            await self._http_send("delete", cx or default_context())
            return
        if self.is_sim():
            node, name = self._sim_node()
            await node.delete(name)
            return
        if self.is_slab():
            # GC of a packed chunk marks its extent dead for
            # SlabStore.compact; the slab file is never punched
            unlink = functools.partial(self._slab_store().mark_dead,
                                       self._slab_parts()[1])
        else:
            unlink = functools.partial(_fsio.unlink, self.target)
        try:
            await asyncio.to_thread(unlink)
        except OSError as err:
            raise LocationError(str(err)) from err

    async def file_exists(self, cx: Optional[LocationContext] = None) -> bool:
        if self.is_http():
            resp = await self._http_send("head", cx or default_context())
            return resp.status < 400
        if self.is_sim():
            node, name = self._sim_node()
            return await node.exists(name)
        if self.is_slab():
            ext = await asyncio.to_thread(self._slab_store().lookup,
                                          self._slab_parts()[1])
            return ext is not None
        return await asyncio.to_thread(os.path.exists, self.target)

    async def file_len(self, cx: Optional[LocationContext] = None) -> int:
        if self.is_sim():
            node, name = self._sim_node()
            return await node.length(name)
        if self.is_slab():
            name = self._slab_parts()[1]
            ext = await asyncio.to_thread(self._slab_store().lookup, name)
            if ext is None:
                raise LocationError(f"no live chunk {name!r} in slab store")
            return ext.length
        if self.is_http():
            resp = await self._http_send("head", cx or default_context())
            if resp.status >= 400:
                raise HttpStatusError(resp.status, self.target)
            length = resp.headers.get("Content-Length")
            if length is None:
                raise LocationError(f"no Content-Length from {self.target}")
            return int(length)
        try:
            st = await asyncio.to_thread(os.stat, self.target)
        except OSError as err:
            raise LocationError(str(err)) from err
        return st.st_size

    # ---- shard writing (ShardWriter for Location,
    #      src/file/location.rs:605-616) ----

    async def write_shard(self, hash_: AnyHash, data: bytes,
                          cx: Optional[LocationContext] = None
                          ) -> list["Location"]:
        loc = await self.write_subfile(str(hash_), data, cx)
        return [loc]
