"""Async byte-stream primitives for the host I/O plane: the port of
``chunky_bits_tpu/utils/aio.py``.

Filesystem work hops to threads, and byte streams are objects with
``async read(n)``.  The ingest path's zero-copy source is
``FileReader.view_parts``: read-only page-cache views that reach the
encoder (and ``ops.backend.as_tensor``, which aliases them) without a
copy, so nothing downstream may write into them.
"""

from __future__ import annotations

import asyncio
import io
import os
from typing import AsyncIterator, Optional, Protocol, runtime_checkable


def mmap_opted_out() -> bool:
    """True when ``$CHUNKY_BITS_TORCH_NO_MMAP`` is set to a true value
    (``env_flag`` parsing): every read and ingest source then stays off
    mmap.  Read per call."""
    from chunky_bits_tpu_torch.cluster.tunables import NO_MMAP_ENV, env_flag

    return env_flag(NO_MMAP_ENV)


@runtime_checkable
class AsyncByteReader(Protocol):
    """Anything with ``async read(n) -> bytes-like`` (b'' at EOF).

    ``read(-1)`` drains to EOF; ``read(n)`` may return fewer than n bytes
    (never zero before EOF); the value may be bytes, bytearray or a
    memoryview, so consumers treat it as a buffer."""

    async def read(self, n: int = -1) -> bytes:  # pragma: no cover
        ...


class BytesReader:
    """In-memory reader."""

    def __init__(self, data: bytes):
        self._buf = io.BytesIO(data)

    async def read(self, n: int = -1) -> bytes:
        return self._buf.read(n)

    async def readinto(self, mem: memoryview) -> int:
        return self._buf.readinto(mem)


async def open_in_thread(opener, closer):
    """``asyncio.to_thread(opener)`` that never leaks what it opened: the
    open runs shielded, and if the awaiting task is cancelled anyway,
    ``closer`` reaps the result the moment the thread finishes.  Opener
    errors propagate unchanged."""
    t = asyncio.ensure_future(asyncio.to_thread(opener))
    try:
        return await asyncio.shield(t)
    except asyncio.CancelledError:
        def _reap(task: "asyncio.Task") -> None:
            if task.cancelled() or task.exception() is not None:
                return  # retrieving the exception also silences asyncio
            try:
                closer(task.result())
            except Exception:  # lint: broad-except-ok reaping an orphan
                pass  # nobody is left to hear about a failed close
        if t.done():
            _reap(t)
        else:
            t.add_done_callback(_reap)
        raise


class FileReader:
    """Thread-offloaded file reader.

    Regular files also expose ``view_parts``: zero-copy page-cache views
    for the ingest staging path (file/writer.py), so a local source skips
    the read() memcpy entirely."""

    _NO_MAP = object()  # sentinel: mapping attempted and unavailable

    def __init__(self, path: str, offset: int = 0,
                 fileobj: Optional[io.BufferedReader] = None):
        self._path = path
        self._f = fileobj
        self._offset = offset
        self._mm = None  # lazy mmap; _NO_MAP when the source can't map

    async def _ensure(self) -> io.BufferedReader:
        if self._f is None:
            def _open() -> io.BufferedReader:
                f = open(self._path, "rb")
                try:
                    if self._offset:
                        f.seek(self._offset)
                except BaseException:
                    f.close()
                    raise
                return f

            self._f = await open_in_thread(_open, lambda f: f.close())
        return self._f

    async def read(self, n: int = -1) -> bytes:
        f = await self._ensure()
        return await asyncio.to_thread(f.read, n)

    async def readinto(self, mem: memoryview) -> int:
        f = await self._ensure()
        return await asyncio.to_thread(f.readinto, mem)

    def _view_parts_sync(self, f, part_bytes: int, max_parts: int):
        if self._mm is None:
            import mmap

            if mmap_opted_out():
                self._mm = self._NO_MAP
                return None
            try:
                self._mm = mmap.mmap(f.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except (ValueError, OSError, io.UnsupportedOperation,
                    AttributeError):
                # empty file, pipe/char device, or no fileno
                self._mm = self._NO_MAP
        if self._mm is self._NO_MAP:
            return None
        pos = f.tell()
        k = min(max_parts, (len(self._mm) - pos) // part_bytes)
        if k <= 0:
            return None
        f.seek(pos + k * part_bytes)
        return memoryview(self._mm)[pos:pos + k * part_bytes]

    async def view_parts(self, part_bytes: int,
                         max_parts: int) -> Optional[memoryview]:
        """Read-only view of the next k = min(``max_parts``, full parts
        remaining) * ``part_bytes`` bytes, advancing the stream past them;
        ``None`` when no full part remains (the tail flows through
        read()/readinto()) or the source cannot be mapped.  The view
        aliases the page cache through a private read-only mmap and stays
        valid while anything holds it.  A source truncated by another
        process mid-ingest raises SIGBUS on a mapped page past the new
        end: set ``$CHUNKY_BITS_TORCH_NO_MMAP=1`` for such sources."""
        f = await self._ensure()
        return await asyncio.to_thread(
            self._view_parts_sync, f, part_bytes, max_parts)

    async def close(self) -> None:
        if self._mm is not None and self._mm is not self._NO_MAP:
            try:
                self._mm.close()
            except BufferError:
                pass  # exported views outlive us; GC reclaims the map
            self._mm = None
        if self._f is not None:
            await asyncio.to_thread(self._f.close)
            self._f = None


async def close_reader(reader) -> None:
    """Close a reader if it supports closing."""
    close = getattr(reader, "close", None)
    if close is not None:
        result = close()
        if hasattr(result, "__await__"):
            # lint: unbounded-deadline-ok reader close releases local
            # fds / returns pooled connections — no network round-trip;
            # bounding it would strand the resource it exists to free
            await result


class CountingReader:
    """Pass-through reader that counts the bytes consumed (``.total``);
    the base reader stays the caller's to close.  With ``max_bytes`` set,
    a read that takes the count past it raises ``exc_factory()`` (the
    gateway's PUT size cap)."""

    def __init__(self, base, max_bytes=None, exc_factory=None):
        self._base = base
        self._max_bytes = max_bytes
        self._exc_factory = exc_factory or (
            lambda: ValueError("byte limit exceeded"))
        self.total = 0

    async def read(self, n: int = -1) -> bytes:
        data = await self._base.read(n)
        self.total += len(data)
        if self._max_bytes is not None and self.total > self._max_bytes:
            raise self._exc_factory()
        return data


async def copy_reader_to_file(reader: AsyncByteReader, path: str,
                              chunk: int = 1 << 20) -> int:
    """Streaming copy into ``path`` with the writes on a thread, double
    buffered: the write of block n overlaps the read of block n+1 (the
    reference's io_copy, src/bin/chunky-bits/util.rs:14-59).  The file is
    opened through the filesystem seam.  Returns the bytes copied."""
    from chunky_bits_tpu_torch.utils import fsio as _fsio

    total = 0
    f = await asyncio.to_thread(_fsio.open, path, "wb")
    pending: Optional[asyncio.Future] = None
    try:
        while True:
            data = await reader.read(chunk)
            if pending is not None:
                await pending
                pending = None
            if not data:
                break
            # lint: task-custody-ok awaited at the loop head or gathered
            # in the finally; the dataflow cannot correlate the
            # `pending is not None` guard with this assignment
            pending = asyncio.ensure_future(
                asyncio.to_thread(f.write, data))
            total += len(data)
        await asyncio.to_thread(f.flush)
    finally:
        if pending is not None:
            await asyncio.gather(pending, return_exceptions=True)
        await asyncio.to_thread(f.close)
    return total


async def copy_reader_to_writer(reader: AsyncByteReader, write,
                                chunk: int = 1 << 20) -> int:
    """Streaming copy into an ``async write(bytes)`` callable, double
    buffered as ``copy_reader_to_file`` is: the write of block n runs as a
    task while block n+1 is read (the reference's io_copy,
    src/bin/chunky-bits/util.rs:14-59).  A write that raises propagates
    from the next step or the ``finally``, so no task is left pending.
    Returns the bytes copied."""
    total = 0
    pending: Optional[asyncio.Future] = None
    try:
        while True:
            data = await reader.read(chunk)
            if pending is not None:
                await pending
                pending = None
            if not data:
                break
            # lint: task-custody-ok awaited at the loop head or in the
            # finally; the dataflow cannot correlate the
            # `pending is not None` guard with this assignment
            pending = asyncio.ensure_future(write(data))
            total += len(data)
    finally:
        if pending is not None:
            await pending
    return total


def fs_path_join(base: str, name: str) -> str:
    """``base`` joined with ``name`` as the host's paths join."""
    return os.path.join(base, name)


async def gather_or_cancel(awaitables):
    """``asyncio.gather`` with fail-fast cleanup: on the first error (or
    outer cancellation) cancel the sibling tasks and await them, so no
    task keeps running with its exception never retrieved.  Returns the
    results in order."""
    tasks = [asyncio.ensure_future(a) for a in awaitables]
    try:
        return await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise


class TakeReader:
    """Limit an underlying reader to ``length`` bytes; closes the inner
    reader once the limit is reached."""

    def __init__(self, inner: AsyncByteReader, length: int):
        self._inner = inner
        self._remaining = length

    async def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if n < 0 or n > self._remaining:
            n = self._remaining
        data = await self._inner.read(n)
        self._remaining -= len(data)
        if self._remaining <= 0 or not data:
            await close_reader(self._inner)
        return data

    async def close(self) -> None:
        await close_reader(self._inner)


class ZeroExtendReader:
    """After EOF on the inner reader, keep yielding zeros up to ``length``
    bytes in all (the reference's ``chain(repeat(0)).take(len)``)."""

    def __init__(self, inner: AsyncByteReader, length: int):
        self._inner = inner
        self._remaining = length
        self._eof = False

    async def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if n < 0 or n > self._remaining:
            n = self._remaining
        if not self._eof:
            data = await self._inner.read(n)
            if data:
                self._remaining -= len(data)
                if self._remaining <= 0:
                    await close_reader(self._inner)
                return data
            self._eof = True
            await close_reader(self._inner)
        out = b"\0" * n
        self._remaining -= n
        return out

    async def close(self) -> None:
        await close_reader(self._inner)


class IterReader:
    """Adapt an async iterator of byte chunks into a reader.  A chunk that
    satisfies a read(n) whole passes through uncopied; read(-1) drains to
    EOF and returns joined bytes."""

    def __init__(self, it: AsyncIterator[bytes]):
        self._it = it
        self._pending = b""
        self._eof = False

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            parts = [self._pending] if self._pending else []
            self._pending = b""
            while not self._eof:
                try:
                    parts.append(await self._it.__anext__())
                except StopAsyncIteration:
                    self._eof = True
            return b"".join(parts)
        if self._pending:
            if len(self._pending) <= n:
                out, self._pending = self._pending, b""
            else:
                out, self._pending = self._pending[:n], self._pending[n:]
            return out
        if self._eof:
            return b""
        try:
            chunk = await self._it.__anext__()
        except StopAsyncIteration:
            self._eof = True
            return b""
        if len(chunk) <= n:
            return chunk  # pass through, no copy
        view = memoryview(chunk)
        self._pending = view[n:]
        return view[:n]


async def read_exact_into(reader: AsyncByteReader, mem: memoryview) -> int:
    """Fill ``mem`` until full or EOF and return the bytes filled: through
    ``readinto`` when the reader has it (bytes land in the caller's
    buffer), else by copying each ``read()`` chunk into place."""
    n = len(mem)
    got = 0
    readinto = getattr(reader, "readinto", None)
    if readinto is not None:
        while got < n:
            filled = await readinto(mem[got:])
            if not filled:
                break
            got += filled
        return got
    while got < n:
        data = await reader.read(n - got)
        if not data:
            break
        mem[got:got + len(data)] = data
        got += len(data)
    return got
