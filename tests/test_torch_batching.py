"""The port's batchers end without spinning, and hold a group's requests
behind a backend that runs one dispatch at a time.

``_CoalescingBatcher.aclose`` used to gather every task it still listed.
A dispatch that finished in the same loop step stays listed until its
``discard`` callback runs, and on Python 3.12 ``asyncio.gather`` over tasks
that are all done completes without yielding to the loop, so the callback
never ran and ``aclose`` looped forever.  Each probe runs in a subprocess
with a time limit, so a regression fails one test instead of holding a
test worker until the suite's own limit.

The batchers' results are held against the JAX package's numpy backend on
the same seeded inputs, at tolerance 0.
"""

import asyncio
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from chunky_bits_tpu.ops.backend import get_coder as jax_coder
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import backend
from chunky_bits_tpu_torch.ops.batching import (EncodeHashBatcher,
                                                ReconstructBatcher)
from tests.test_torch_file import TIMEOUT, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a probe subprocess may take (torch's import is most of it)
PROBE_TIMEOUT = 60

_PROBE_HEAD = """
import asyncio, sys
import numpy as np
from chunky_bits_tpu_torch.ops.backend import get_coder
from chunky_bits_tpu_torch.ops.batching import (EncodeHashBatcher,
                                                ReconstructBatcher)
rng = np.random.default_rng(7)
"""

PROBES = {
    # one reconstruct of a d=5 p=3 part, then aclose in the same task
    "reconstruct": """
async def main():
    b = ReconstructBatcher(backend="numpy")
    data = rng.integers(0, 256, (5, 64), dtype=np.uint8)
    rows = list(data) + get_coder(5, 3, "numpy").encode(list(data))
    arrays = list(rows)
    arrays[0] = arrays[6] = None
    out = await b.reconstruct(5, 3, arrays)
    await b.aclose()
    assert b.dispatches == 1
    assert all(np.array_equal(x, y) for x, y in zip(out, rows))
""",
    "encode_hash": """
async def main():
    b = EncodeHashBatcher(backend="numpy")
    data = rng.integers(0, 256, (2, 5, 64), dtype=np.uint8)
    parity, digests = await b.encode_hash(5, 3, data)
    await b.aclose()
    assert parity.shape == (2, 3, 64) and digests.shape == (2, 8, 32)
""",
    # a failed dispatch: the error reaches its waiter, aclose returns
    "failed_dispatch": """
async def main():
    b = EncodeHashBatcher(backend="numpy")
    b._run_group = lambda key, payloads: 1 / 0
    data = rng.integers(0, 256, (1, 5, 64), dtype=np.uint8)
    try:
        await b.encode_hash(5, 3, data)
    except ZeroDivisionError:
        pass
    else:
        raise AssertionError("the dispatch error was not delivered")
    await b.aclose()
""",
    # aclose awaited while the dispatch is still running
    "concurrent": """
async def main():
    b = ReconstructBatcher(backend="numpy")
    rows = [rng.integers(0, 256, 4096, dtype=np.uint8) for _ in range(8)]
    reqs = []
    for miss in ((0,), (1, 2), (0,)):
        arrays = list(rows)
        for i in miss:
            arrays[i] = None
        reqs.append(asyncio.ensure_future(b.reconstruct(5, 3, arrays)))
    await asyncio.sleep(0)
    await b.aclose()
    assert all(r.done() for r in reqs)
    assert b.dispatches == 2
""",
    # aclose while requests are held behind a running dispatch on a
    # backend that runs one at a time: they leave as one more dispatch
    "held": """
import threading
from chunky_bits_tpu_torch.ops.backend import NumpyBackend, register_backend

class Gated(NumpyBackend):
    name = "gated"
    prefers_merged_batches = True
    concurrent_dispatches = 1
    entered = threading.Event()
    release = threading.Event()

    def apply_matrix(self, mat, shards):
        self.entered.set()
        self.release.wait(30)
        return super().apply_matrix(mat, shards)

register_backend(Gated())

async def main():
    b = EncodeHashBatcher(backend="gated")
    data = rng.integers(0, 256, (4, 5, 64), dtype=np.uint8)
    reqs = [asyncio.ensure_future(b.encode_hash(5, 3, data[:1]))]
    await asyncio.to_thread(Gated.entered.wait, 30)
    reqs += [asyncio.ensure_future(b.encode_hash(5, 3, data[i:i + 1]))
             for i in range(1, 4)]
    for _ in range(100):
        if b.held == 3:
            break
        await asyncio.sleep(0)
    assert b.held == 3 and not any(r.done() for r in reqs)
    asyncio.get_running_loop().call_later(0.05, Gated.release.set)
    await b.aclose()
    assert all(r.done() for r in reqs)
    assert (b.dispatches, b.held) == (2, 3)
    want = get_coder(5, 3, "numpy").encode_hash_batch(data)
    for i, r in enumerate(reqs):
        parity, digests = r.result()
        assert np.array_equal(parity, want[0][i:i + 1])
        assert np.array_equal(digests, want[1][i:i + 1])
""",
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_aclose_returns_right_after_the_last_dispatch(probe):
    code = _PROBE_HEAD + textwrap.dedent(PROBES[probe]) + \
        "\nasyncio.run(main())\nprint('probe ok')\n"
    env = dict(os.environ, PYTHONPATH=REPO)
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=PROBE_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"aclose did not return within {PROBE_TIMEOUT} s")
    assert proc.returncode == 0, proc.stderr
    assert "probe ok" in proc.stdout


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batchers_equal_the_jax_package(seed):
    """Concurrent requests through both batchers, then aclose, equal the
    JAX package's numpy coder on the same inputs."""
    rng = np.random.default_rng(seed)
    d, p, s = 5, 3, 257
    data = rng.integers(0, 256, (3, d, s), dtype=np.uint8)
    ref = jax_coder(d, p, "numpy")

    async def drive():
        enc = EncodeHashBatcher(backend="numpy")
        dec = ReconstructBatcher(backend="numpy")
        outs = await asyncio.gather(*(enc.encode_hash(d, p, data[i:i + 1])
                                      for i in range(3)))
        await enc.aclose()
        full = [list(data[i]) + list(outs[i][0][0]) for i in range(3)]
        for rows in full:
            for i in (0, 2, 6):
                rows[i] = None
        rebuilt = await asyncio.gather(*(dec.reconstruct(d, p, rows)
                                         for rows in full))
        await dec.aclose()
        return outs, rebuilt

    outs, rebuilt = run(drive())
    for i, (parity, digests) in enumerate(outs):
        want_p, want_d = ref.encode_hash_batch(data[i:i + 1])
        assert np.array_equal(parity, want_p)
        assert np.array_equal(digests, want_d)
        whole = np.concatenate([data[i], want_p[0]])
        assert np.array_equal(np.stack(rebuilt[i]), whole)


def test_aclose_with_nothing_pending_returns():
    async def drive():
        b = ReconstructBatcher(backend="numpy")
        await b.aclose()
        with pytest.raises(ErasureError):
            await b.reconstruct(2, 1, [None, None, None])
        await b.aclose()
        return b.dispatches

    assert run(drive()) == 0


class _GatedBackend(backend.NumpyBackend):
    """The numpy codec behind a backend that merges, runs one dispatch at
    a time and hands out host buffers (noting their shapes), whose first
    walk waits for ``release``."""

    prefers_merged_batches = True
    concurrent_dispatches = 1

    def __init__(self, name: str):
        self.name = name
        self.entered = threading.Event()
        self.release = threading.Event()
        self.walks = 0
        self.buffers = []

    def host_buffer(self, shape):
        self.buffers.append(shape)
        return np.empty(shape, dtype=np.uint8)

    def apply_matrix(self, mat, shards):
        self.walks += 1
        if self.walks == 1:
            self.entered.set()
            assert self.release.wait(TIMEOUT)
        return super().apply_matrix(mat, shards)


@pytest.mark.parametrize("kind", ["encode_hash", "reconstruct"])
def test_requests_held_behind_a_walk_leave_as_one_dispatch(kind,
                                                           monkeypatch):
    """One request, then 15 while its walk is blocked: the 15 are held and
    leave together, 2 dispatches in all, each result equal to the JAX
    package's numpy coder."""
    rng = np.random.default_rng(19)
    d, p, s, n = 5, 3, 257, 16
    data = rng.integers(0, 256, (n, d, s), dtype=np.uint8)
    want_p, want_d = jax_coder(d, p, "numpy").encode_hash_batch(data)
    gated = _GatedBackend(f"gated-{kind}")
    monkeypatch.setitem(backend._REGISTRY, gated.name, gated)
    monkeypatch.setattr(backend, "_CODER_CACHE", {})

    async def drive():
        if kind == "encode_hash":
            b = EncodeHashBatcher(backend=gated.name)

            def call(i):
                return b.encode_hash(d, p, data[i:i + 1])
        else:
            b = ReconstructBatcher(backend=gated.name)

            def call(i):
                rows = list(data[i]) + list(want_p[i])
                rows[0] = rows[6] = None
                return b.reconstruct(d, p, rows)

        reqs = [asyncio.ensure_future(call(0))]
        try:
            assert await asyncio.to_thread(gated.entered.wait, TIMEOUT)
            reqs += [asyncio.ensure_future(call(i)) for i in range(1, n)]
            for _ in range(100):
                if b.held == n - 1:
                    break
                await asyncio.sleep(0)
            held_before_release = b.held
        finally:
            gated.release.set()
        outs = await asyncio.gather(*reqs)
        await b.aclose()
        return b, held_before_release, outs

    b, held_before_release, outs = run(drive())
    assert held_before_release == n - 1
    assert (b.dispatches, b.held, gated.walks) == (2, n - 1, 2)
    # a merge, and a decode's gather, fill the backend's host buffer
    merged = [(n - 1, d, s)]
    assert gated.buffers == (merged if kind == "encode_hash"
                             else [(1, d, s)] + merged)
    for i, out in enumerate(outs):
        if kind == "encode_hash":
            assert np.array_equal(out[0], want_p[i:i + 1])
            assert np.array_equal(out[1], want_d[i:i + 1])
        else:
            whole = np.concatenate([data[i], want_p[i]])
            assert np.array_equal(np.stack(out), whole)
