"""The port's async byte substrate (``chunky_bits_tpu_torch/utils/aio.py``):
the mirror of ``tests/test_aio.py``.

``read_exact_into`` (the writer's zero-restage ingest primitive: readinto
fast path, read() fallback, partial fills, EOF), the file reader's
``readinto`` and page-cache view parts with ``CHUNKY_BITS_TORCH_NO_MMAP``,
the reader iteration contract, and ``open_in_thread``'s cancel-safe open.
Every loop run is bounded by ``tests/test_torch_file.py::bounded``.
"""

import asyncio

import numpy as np
import pytest

from chunky_bits_tpu_torch.utils import aio
from tests.test_torch_file import bounded


class DribbleReader:
    """read()-only reader serving at most ``step`` bytes per call."""

    def __init__(self, data: bytes, step: int):
        self._data = data
        self._off = 0
        self._step = step
        self.calls = 0

    async def read(self, n: int = -1) -> bytes:
        self.calls += 1
        if self._off >= len(self._data):
            return b""
        n = min(n if n >= 0 else self._step, self._step,
                len(self._data) - self._off)
        out = self._data[self._off:self._off + n]
        self._off += n
        return out


class DribbleIntoReader(DribbleReader):
    """readinto-capable variant with the same dribble behavior."""

    async def readinto(self, mem: memoryview) -> int:
        self.calls += 1
        if self._off >= len(self._data):
            return 0
        n = min(len(mem), self._step, len(self._data) - self._off)
        mem[:n] = self._data[self._off:self._off + n]
        self._off += n
        return n


@pytest.mark.parametrize("cls", [DribbleReader, DribbleIntoReader])
@pytest.mark.parametrize("step", [1, 7, 64, 1000])
def test_read_exact_into_fills_exactly(cls, step):
    data = bytes(range(256)) * 4  # 1024 bytes
    buf = np.zeros(600, dtype=np.uint8)

    async def main():
        reader = cls(data, step)
        got = await aio.read_exact_into(reader, memoryview(buf))
        assert got == 600
        assert buf.tobytes() == data[:600]
        # second fill continues from where the reader left off
        buf2 = np.zeros(600, dtype=np.uint8)
        got = await aio.read_exact_into(reader, memoryview(buf2))
        assert got == len(data) - 600  # EOF short fill
        assert buf2.tobytes()[:got] == data[600:]
        # at EOF: zero filled
        assert await aio.read_exact_into(reader, memoryview(buf2)) == 0

    bounded(lambda: asyncio.run(main()))


def test_read_exact_into_prefers_readinto():
    data = b"x" * 100

    async def main():
        reader = DribbleIntoReader(data, 1000)
        buf = np.zeros(100, dtype=np.uint8)
        await aio.read_exact_into(reader, memoryview(buf))
        assert buf.tobytes() == data

    bounded(lambda: asyncio.run(main()))


def test_builtin_readers_readinto():
    """BytesReader and FileReader expose the zero-copy path."""

    async def main():
        data = bytes(range(200))
        buf = np.zeros(200, dtype=np.uint8)
        r = aio.BytesReader(data)
        assert await aio.read_exact_into(r, memoryview(buf)) == 200
        assert buf.tobytes() == data

    bounded(lambda: asyncio.run(main()))


def test_file_reader_readinto(tmp_path):
    async def main():
        data = bytes(range(256)) * 3
        path = tmp_path / "f.bin"
        path.write_bytes(data)
        r = aio.FileReader(str(path), offset=100)
        buf = np.zeros(500, dtype=np.uint8)
        assert await aio.read_exact_into(r, memoryview(buf)) == 500
        assert buf.tobytes() == data[100:600]
        await r.close()

    bounded(lambda: asyncio.run(main()))


def test_file_reader_view_parts(tmp_path, monkeypatch):
    """Zero-copy staging views: whole parts served as mmap views that
    advance the stream position, interleaving cleanly with readinto for
    the tail."""
    monkeypatch.delenv("CHUNKY_BITS_TORCH_NO_MMAP", raising=False)
    part = 96
    data = bytes(range(256)) * 2  # 512 bytes = 5 parts + 32-byte tail

    async def main():
        path = tmp_path / "f.bin"
        path.write_bytes(data)
        r = aio.FileReader(str(path))
        mv = await r.view_parts(part, 3)
        assert mv is not None and len(mv) == 3 * part
        assert bytes(mv) == data[:3 * part]
        # view is zero-copy: frombuffer aliases the page cache
        arr = np.frombuffer(mv, dtype=np.uint8)
        assert not arr.flags.writeable
        mv2 = await r.view_parts(part, 3)
        assert len(mv2) == 2 * part  # only 2 full parts remain
        assert bytes(mv2) == data[3 * part:5 * part]
        assert await r.view_parts(part, 3) is None  # tail < one part
        buf = np.zeros(64, dtype=np.uint8)
        got = await aio.read_exact_into(r, memoryview(buf))
        assert got == 32  # the tail, exactly where the views left off
        assert buf[:32].tobytes() == data[5 * part:]
        await r.close()

    bounded(lambda: asyncio.run(main()))


def test_file_reader_view_parts_offset_and_unmappable(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("CHUNKY_BITS_TORCH_NO_MMAP", raising=False)

    async def main():
        data = bytes(range(256))
        path = tmp_path / "f.bin"
        path.write_bytes(data)
        # seeked reader: views start at the offset
        r = aio.FileReader(str(path), offset=16)
        mv = await r.view_parts(80, 8)  # 240 bytes remain = 3 full parts
        assert len(mv) == 240 and bytes(mv) == data[16:]
        await r.close()
        # empty file can't mmap: view path declines, byte path sees EOF
        empty = tmp_path / "empty.bin"
        empty.write_bytes(b"")
        r = aio.FileReader(str(empty))
        assert await r.view_parts(64, 4) is None
        assert await r.read(10) == b""
        await r.close()

    bounded(lambda: asyncio.run(main()))


def test_view_parts_opt_out(tmp_path, monkeypatch):
    """CHUNKY_BITS_TORCH_NO_MMAP=1 keeps every part on the readinto copy
    path (for sources subject to concurrent truncation)."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_NO_MMAP", "1")

    async def main():
        data = bytes(range(256))
        path = tmp_path / "f.bin"
        path.write_bytes(data)
        r = aio.FileReader(str(path))
        assert await r.view_parts(64, 2) is None
        assert r._mm is aio.FileReader._NO_MAP
        buf = np.zeros(256, dtype=np.uint8)
        assert await aio.read_exact_into(r, memoryview(buf)) == 256
        assert buf.tobytes() == data
        await r.close()

    bounded(lambda: asyncio.run(main()))


def test_iter_reader_contract():
    """IterReader: read(-1) drains to EOF as joined bytes; read(n)
    passes whole chunks through uncopied (short reads allowed) and
    splits oversized chunks via views; b'' only at EOF."""

    async def chunks():
        yield b"aaaa"
        yield memoryview(b"bbbbbbbb")
        yield b"cc"

    async def main():
        # slurp drains everything as bytes
        r = aio.IterReader(chunks())
        assert await r.read() == b"aaaabbbbbbbbcc"
        assert await r.read() == b""
        # bounded reads: pass-through, then split, then drain
        r = aio.IterReader(chunks())
        assert bytes(await r.read(100)) == b"aaaa"  # short, not padded
        first = await r.read(3)
        assert bytes(first) == b"bbb"
        assert bytes(await r.read(100)) == b"bbbbb"  # pending remainder
        # slurp after bounded reads picks up pending + rest
        r = aio.IterReader(chunks())
        head = await r.read(2)
        assert bytes(head) == b"aa"
        assert await r.read() == b"aabbbbbbbbcc"
        assert await r.read(5) == b""

    bounded(lambda: asyncio.run(main()))


def test_mmap_opt_out_env_parsing(monkeypatch):
    """Standard env-flag semantics: unset/empty/0/false/no/off keep the
    mmap paths ON; truthy values opt out."""
    for val in (None, "", "0", "false", "No", "OFF"):
        if val is None:
            monkeypatch.delenv("CHUNKY_BITS_TORCH_NO_MMAP", raising=False)
        else:
            monkeypatch.setenv("CHUNKY_BITS_TORCH_NO_MMAP", val)
        assert not aio.mmap_opted_out(), repr(val)
    for val in ("1", "true", "yes", "anything"):
        monkeypatch.setenv("CHUNKY_BITS_TORCH_NO_MMAP", val)
        assert aio.mmap_opted_out(), repr(val)


def test_open_in_thread_cancel_reaps_orphan():
    """Cancelling the awaiting task while the open hop is mid-thread
    must close the orphaned handle instead of abandoning it to GC (the
    ResourceWarning a scrub rolling restart or a cancelled hedge loser
    used to trip in tests/test_chaos.py)."""
    import threading

    gate = threading.Event()
    opened = []

    class Handle:
        closed = False

        def close(self):
            self.closed = True

    def opener():
        gate.wait(5)
        h = Handle()
        opened.append(h)
        return h

    async def main():
        task = asyncio.ensure_future(
            aio.open_in_thread(opener, lambda h: h.close()))
        await asyncio.sleep(0.05)  # park the thread on the gate
        task.cancel()
        gate.set()
        with pytest.raises(asyncio.CancelledError):
            await task
        for _ in range(200):  # the reap callback runs when the thread lands
            if opened and opened[0].closed:
                break
            await asyncio.sleep(0.01)
        assert opened and opened[0].closed

    bounded(lambda: asyncio.run(main()))


def test_open_in_thread_plain_paths():
    """Uncancelled awaits hand the handle over unclosed; opener errors
    propagate (nothing to reap — a failed open owns its own cleanup)."""
    class Handle:
        closed = False

        def close(self):
            self.closed = True

    async def main():
        h = await aio.open_in_thread(Handle, lambda x: x.close())
        assert not h.closed

        def boom():
            raise FileNotFoundError("nope")

        with pytest.raises(FileNotFoundError):
            await aio.open_in_thread(boom, lambda x: x.close())

    bounded(lambda: asyncio.run(main()))


#: ``copy_reader_to_writer``'s default block
COPY_CHUNK = 1 << 20


def _copy_to_writer(mod, data, **kwargs):
    """``mod.copy_reader_to_writer`` of ``data`` into a list; returns the
    count it reports and the blocks the writer saw."""
    async def main():
        got = []

        async def write(block):
            await asyncio.sleep(0)
            got.append(bytes(block))

        n = await mod.copy_reader_to_writer(mod.BytesReader(data), write,
                                            **kwargs)
        return n, got

    return bounded(lambda: asyncio.run(main()))


@pytest.mark.parametrize("size", [0, 1, COPY_CHUNK - 1, COPY_CHUNK,
                                  COPY_CHUNK + 1])
def test_copy_reader_to_writer_equals_reference(size):
    """The byte count and the blocks written equal the JAX package's, at
    the default block and around it."""
    from chunky_bits_tpu.utils import aio as jaio

    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    ours = _copy_to_writer(aio, data)
    assert ours == _copy_to_writer(jaio, data)
    assert ours[0] == size and b"".join(ours[1]) == data


@pytest.mark.parametrize("fail_at", [1, 2, 10])
def test_copy_reader_to_writer_write_error_propagates(fail_at):
    """A write that raises propagates out of the copy, no write starts
    after it, and no task is left pending, as in the JAX package."""
    from chunky_bits_tpu.utils import aio as jaio

    def attempt(mod):
        async def main():
            calls = []

            async def write(block):
                calls.append(len(block))
                await asyncio.sleep(0)
                if len(calls) == fail_at:
                    raise OSError("disk full")

            with pytest.raises(OSError, match="disk full"):
                await mod.copy_reader_to_writer(
                    mod.BytesReader(b"x" * 10_000), write, chunk=1000)
            others = asyncio.all_tasks() - {asyncio.current_task()}
            assert not others
            return calls

        return bounded(lambda: asyncio.run(main()))

    assert attempt(aio) == attempt(jaio) == [1000] * fail_at


def test_fs_path_join_equals_reference():
    from chunky_bits_tpu.utils import aio as jaio

    for base, name in [("/a", "b"), ("/a/", "b"), ("a", "/b"), ("", "b")]:
        assert aio.fs_path_join(base, name) == jaio.fs_path_join(base, name)
