"""The port's scheduled-XOR engine (``chunky_bits_tpu_torch/ops/
xor_schedule.py`` + ``cb_xor_exec`` of its ``csrc/gf256.cpp``), held to
the cases of ``tests/test_xor_schedule.py`` and against the JAX package.

* Byte identity: schedules run by the numpy executor and by the native
  engine (at every forced kernel tier, the scalar one included) give the
  table codec's bytes, for encode, decode with erasures and the fused
  ingest, flag on or off; and the port compiles the same program as the
  JAX package for the same matrix.
* The schedule cache is a bounded LRU by matrix digest.
* Programs are well formed (every temp defined before use, every output
  seeded by a copy or a zero, CSE below the raw XOR count), and the
  symbolic verifier refuses a corrupted one.

The decode-path case ends its batcher right after the dispatch; it runs
inside a time bound (the batcher's ``aclose`` used to spin there).
"""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

from chunky_bits_tpu.ops import xor_schedule as jax_xs
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import cpu_backend, matrix, xor_schedule
from chunky_bits_tpu_torch.ops.backend import (ErasureCoder, NumpyBackend,
                                               register_backend)
from chunky_bits_tpu_torch.ops.cpu_backend import NativeBackend
from tests.test_torch_file import bounded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def force_impl():
    """Force the XOR engine's tier for one test, restoring the detected
    best afterwards (the toggle is process-wide)."""
    yield cpu_backend.xor_force_impl
    cpu_backend.xor_force_impl(2)


# ---- schedule structure ----

def test_schedule_well_formed_and_cse_reduces():
    enc = matrix.build_encode_matrix(10, 4)
    sched = xor_schedule.build_schedule(enc[10:])
    assert sched.k == 10 and sched.r == 4
    n_in, out_base = 8 * sched.k, sched.out_base
    defined = set(range(n_in))
    seeded = set()
    for dst, src, kind in sched.ops.tolist():
        assert 0 <= dst < sched.n_planes
        if kind == xor_schedule.OP_ZERO:
            assert dst >= out_base
        else:
            assert src in defined, "use before def"
        if kind == xor_schedule.OP_XOR and dst >= out_base:
            assert dst in seeded, "output XOR before its seeding copy"
        if kind in (xor_schedule.OP_COPY, xor_schedule.OP_ZERO):
            seeded.add(dst)
        defined.add(dst)
    assert set(range(out_base, sched.n_planes)) <= seeded | defined
    assert len(sched.ops) < sched.raw_xors
    assert sched.n_xors < sched.raw_xors - 8 * sched.r
    # the same program, op for op, as the JAX package compiles
    theirs = jax_xs.build_schedule(enc[10:])
    assert np.array_equal(sched.ops, theirs.ops)
    assert (sched.n_temps, sched.raw_xors, sched.digest) == \
        (theirs.n_temps, theirs.raw_xors, theirs.digest)


def test_identity_and_zero_rows_schedule():
    """Decode matrices hold identity rows and all-zero rows."""
    mat = np.zeros((2, 3), dtype=np.uint8)
    mat[0, 1] = 1
    sched = xor_schedule.build_schedule(mat)
    data = np.random.default_rng(0).integers(0, 256, (2, 3, 64),
                                             dtype=np.uint8)
    out = xor_schedule.apply_numpy(sched, data)
    assert np.array_equal(out[:, 0], data[:, 1])
    assert not out[:, 1].any()
    assert np.array_equal(out, jax_xs.apply_numpy(
        jax_xs.build_schedule(mat), data))


def test_planes_roundtrip():
    rows = np.random.default_rng(1).integers(0, 256, (5, 128),
                                             dtype=np.uint8)
    planes = xor_schedule.planes_of(rows)
    assert planes.shape == (40, 16)
    assert np.array_equal(planes, jax_xs.planes_of(rows))
    assert np.array_equal(xor_schedule.bytes_of(planes), rows)
    # plane v, byte t8, bit b = bit v of byte 8*t8+b
    one = np.zeros((1, 8), dtype=np.uint8)
    one[0, 3] = 1 << 5
    p = xor_schedule.planes_of(one)
    assert p[5, 0] == 1 << 3 and p.sum() == (1 << 3)
    with pytest.raises(ErasureError):
        xor_schedule.planes_of(np.zeros((1, 7), dtype=np.uint8))


# ---- executor identity (numpy executor and native, every tier) ----

@pytest.mark.parametrize("seed", range(6))
def test_numpy_executor_matches_table_codec(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 17))
    p = int(rng.integers(1, 9))
    size = int(rng.integers(1, 300)) * 8
    batch = int(rng.integers(1, 4))
    enc = matrix.build_encode_matrix(d, p)
    data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
    want = NumpyBackend().apply_matrix(enc[d:], data)
    sched = xor_schedule.get_schedule(enc[d:])
    assert np.array_equal(xor_schedule.apply_numpy(sched, data), want)
    assert np.array_equal(
        NativeBackend(xor_schedule=True).apply_matrix(enc[d:], data), want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_native_engine_identity_per_tier(level, force_impl):
    """Encode and decode byte identity at every tier (clamped to what this
    CPU has); tier 0 is the scalar executor."""
    eff = force_impl(level)
    assert 0 <= eff <= level
    assert cpu_backend.native_tiers()["xor"] == eff
    off = NativeBackend(xor_schedule=False)
    on = NativeBackend(xor_schedule=True)
    rng = np.random.default_rng(100 + level)
    for d, p, size, batch in ((3, 2, 64, 2), (10, 4, 1024, 2),
                              (1, 1, 8, 1), (16, 8, 1992, 1),
                              (20, 6, 8192, 1), (4, 4, 16, 3)):
        enc = matrix.build_encode_matrix(d, p)
        data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
        want = off.apply_matrix(enc[d:], data)
        assert np.array_equal(want, NumpyBackend().apply_matrix(enc[d:],
                                                                data))
        assert np.array_equal(on.apply_matrix(enc[d:], data), want), \
            (d, p, size)
        full = np.concatenate([data, want], axis=1)
        erased = rng.choice(d + p, size=p, replace=False)
        present = [i for i in range(d + p) if i not in erased]
        dec = matrix.decode_matrix(enc, present, sorted(erased))
        picked = np.ascontiguousarray(full[:, np.array(present[:d]), :])
        assert np.array_equal(on.apply_matrix(dec, picked),
                              off.apply_matrix(dec, picked)), (d, p, size)
        assert np.array_equal(on.apply_matrix(dec, picked),
                              full[:, sorted(erased)]), (d, p, size)


def test_non_multiple_of_8_falls_back_to_table_path(monkeypatch):
    """``cb_xor_exec`` returns without writing when S % 8 != 0, so such
    shapes must take the byte tables: the XOR engine is never called."""
    on = NativeBackend(xor_schedule=True)
    off = NativeBackend(xor_schedule=False)
    calls = []
    real = NativeBackend._xor_apply
    monkeypatch.setattr(NativeBackend, "_xor_apply",
                        lambda self, *a: calls.append(a) or real(self, *a))
    rng = np.random.default_rng(7)
    enc = matrix.build_encode_matrix(3, 2)
    for size in (1, 7, 9, 1001):
        data = rng.integers(0, 256, (2, 3, size), dtype=np.uint8)
        assert np.array_equal(on.apply_matrix(enc[3:], data),
                              off.apply_matrix(enc[3:], data)), size
        parity, digests = on.encode_and_hash(enc[3:], data)
        want = ErasureCoder(3, 2, NumpyBackend()).encode_hash_batch(data)
        assert np.array_equal(parity, want[0])
        assert np.array_equal(digests, want[1])
    assert calls == []


def test_encode_and_hash_into_identity_with_flag_on():
    """The fused ingest entry point, whole and as the host pipeline slices
    it, with the engine on."""
    off = NativeBackend(xor_schedule=False)
    on = NativeBackend(xor_schedule=True)
    rng = np.random.default_rng(8)
    for d, p, size, batch in ((3, 2, 4096, 4), (10, 4, 1 << 16, 2),
                              (2, 0, 512, 2)):
        enc = matrix.build_encode_matrix(d, p)
        data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
        p1, h1 = off.encode_and_hash(enc[d:], data)
        p2, h2 = on.encode_and_hash(enc[d:], data)
        assert np.array_equal(p1, p2), (d, p, size)
        assert np.array_equal(h1, h2), (d, p, size)
        par = np.zeros((batch, p, size), dtype=np.uint8)
        dig = np.zeros((batch, d + p, 32), dtype=np.uint8)
        on.encode_and_hash_into(enc[d:], data, par, dig, 1)
        assert np.array_equal(par, p1) and np.array_equal(dig, h1)


def test_host_pipeline_slicing_identity_with_flag_on():
    from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline

    coder = ErasureCoder(10, 4, NativeBackend(xor_schedule=True))
    stacked = np.random.default_rng(9).integers(0, 256, (8, 10, 4096),
                                                dtype=np.uint8)
    want_p, want_h = ErasureCoder(
        10, 4, NativeBackend(xor_schedule=False)).encode_hash_batch(stacked)
    pipe = HostPipeline(threads=3)
    try:
        got_p, got_h = pipe.encode_hash_sync(coder, stacked)
    finally:
        pipe.close()
    assert np.array_equal(got_p, want_p)
    assert np.array_equal(got_h, want_h)


def test_reconstruct_batcher_decode_path_with_flag_on():
    """The decode route of reads, resilver and the repair planner:
    ``ReconstructBatcher`` -> ``reconstruct_batch_picked`` ->
    ``NativeBackend.apply_matrix`` with a schedule from the shared LRU;
    the batcher is closed right after its dispatch, inside a bound."""
    from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher

    be = NativeBackend(xor_schedule=True)
    be.name = "native-xorsched-test"
    register_backend(be)
    rng = np.random.default_rng(10)
    d, p, size = 5, 3, 2048
    coder = ErasureCoder(d, p, NumpyBackend())
    data = rng.integers(0, 256, (1, d, size), dtype=np.uint8)
    full = np.concatenate([data, coder.encode_batch(data)], axis=1)
    before = xor_schedule.schedule_cache_info()

    async def main():
        batcher = ReconstructBatcher(backend="native-xorsched-test")
        arrays = [None if i in (1, 4, 6) else full[0, i]
                  for i in range(d + p)]
        out = await batcher.reconstruct(d, p, arrays)
        await batcher.aclose()
        return out

    out = bounded(lambda: asyncio.run(main()))
    for i in range(d + p):
        assert np.array_equal(out[i], full[0, i]), i
    after = xor_schedule.schedule_cache_info()
    assert after["hits"] + after["misses"] > before["hits"] + \
        before["misses"]


# ---- the bounded schedule LRU ----

def test_schedule_cache_bound_and_eviction():
    cache = xor_schedule.ScheduleCache(maxsize=3)
    rng = np.random.default_rng(11)
    mats = [rng.integers(1, 256, (2, 3), dtype=np.uint8) for _ in range(5)]
    scheds = [cache.get(m) for m in mats]
    assert len(cache) == 3
    info = cache.info()
    assert info["misses"] == 5 and info["evictions"] == 2
    assert cache.get(mats[-1]) is scheds[-1]
    assert cache.info()["hits"] == 1
    again = cache.get(mats[0])
    assert again is not scheds[0]
    assert np.array_equal(again.ops, scheds[0].ops)
    assert cache.info()["misses"] == 6
    with pytest.raises(ErasureError):
        xor_schedule.ScheduleCache(maxsize=0)


def test_schedule_cache_lru_order():
    cache = xor_schedule.ScheduleCache(maxsize=2)
    a = np.array([[1, 2]], dtype=np.uint8)
    b = np.array([[3, 4]], dtype=np.uint8)
    c = np.array([[5, 6]], dtype=np.uint8)
    sa = cache.get(a)
    cache.get(b)
    assert cache.get(a) is sa
    cache.get(c)
    assert cache.get(a) is sa
    assert cache.info()["evictions"] == 1


def test_shared_cache_is_used_by_dispatch():
    """Dispatches go through the shared LRU, whose counters the metrics
    registry renders as the ``cb_xor_schedule_*`` families, named as the
    JAX package names them."""
    from chunky_bits_tpu_torch.obs import metrics

    on = NativeBackend(xor_schedule=True)
    rng = np.random.default_rng(12)
    mat = rng.integers(1, 256, (2, 4), dtype=np.uint8)
    data = rng.integers(0, 256, (1, 4, 64), dtype=np.uint8)
    before = xor_schedule.schedule_cache_info()
    on.apply_matrix(mat, data)
    on.apply_matrix(mat, data)
    after = xor_schedule.schedule_cache_info()
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] >= before["hits"] + 1
    fams = {f["name"]: f
            for f in metrics.get_registry().snapshot()["families"]}
    for key in ("hits", "misses", "evictions"):
        name = f"cb_xor_schedule_{key}_total"
        assert fams[name]["samples"][0]["value"] >= after[key], name
    assert fams["cb_xor_schedule_entries"]["samples"][0]["value"] >= 1


# ---- flag plumbing ----

def test_tunables_accessor_parses_standard_flag_shapes(monkeypatch):
    from chunky_bits_tpu_torch.cluster import tunables

    assert tunables.XOR_SCHEDULE_ENV == "CHUNKY_BITS_TORCH_XOR_SCHEDULE"
    monkeypatch.delenv(tunables.XOR_SCHEDULE_ENV, raising=False)
    assert tunables.xor_schedule_enabled() is False
    for raw, want in (("1", True), ("on", True), ("0", False),
                      ("false", False), ("", False)):
        monkeypatch.setenv(tunables.XOR_SCHEDULE_ENV, raw)
        assert tunables.xor_schedule_enabled() is want, raw
    # the JAX package's variable does not reach the port
    monkeypatch.delenv(tunables.XOR_SCHEDULE_ENV)
    monkeypatch.setenv("CHUNKY_BITS_TPU_XOR_SCHEDULE", "1")
    assert tunables.xor_schedule_enabled() is False


def test_flag_read_at_first_dispatch(monkeypatch):
    from chunky_bits_tpu_torch.cluster import tunables

    monkeypatch.setenv(tunables.XOR_SCHEDULE_ENV, "1")
    be = NativeBackend()
    assert be._xor is None
    rng = np.random.default_rng(13)
    mat = rng.integers(1, 256, (1, 2), dtype=np.uint8)
    be.apply_matrix(mat, rng.integers(0, 256, (1, 2, 8), dtype=np.uint8))
    assert be._xor is True
    monkeypatch.setenv(tunables.XOR_SCHEDULE_ENV, "0")
    assert be._xor_enabled() is True


# ---- the golden references with the flag on ----

def test_golden_fixtures_identical_with_flag_on():
    """Through the port's writer on ``native`` in a fresh process with
    ``CHUNKY_BITS_TORCH_XOR_SCHEDULE=1``: every golden the port's tests
    reproduce comes out byte for byte, and the engine dispatched."""
    prog = (
        "import asyncio\n"
        "from tests.golden import generate as gen\n"
        "from tests.test_torch_file import GOLDENS, golden\n"
        "from chunky_bits_tpu_torch.file import FileWriteBuilder\n"
        "from chunky_bits_tpu_torch.ops import xor_schedule\n"
        "from chunky_bits_tpu_torch.utils import aio\n"
        "for name, (n, seed, chunk, d, p, blocks) in GOLDENS.items():\n"
        "    ref = asyncio.run(FileWriteBuilder().with_chunk_size(chunk)\n"
        "        .with_data_chunks(d).with_parity_chunks(p)\n"
        "        .with_repair_block_bytes(blocks)\n"
        "        .write(aio.BytesReader(gen.payload(n, seed))))\n"
        "    assert gen.dump(ref.to_obj()) == golden(name), name\n"
        "info = xor_schedule.schedule_cache_info()\n"
        "assert info['misses'] > 0, 'xor engine never dispatched'\n"
        "print('golden ok', info['misses'])\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               CHUNKY_BITS_TORCH_XOR_SCHEDULE="1",
               CHUNKY_BITS_TORCH_BACKEND="native")
    r = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert b"golden ok" in r.stdout


# ---- the static verifier ----

def test_verifier_rejects_corrupted_program():
    mat = matrix.build_encode_matrix(4, 2)
    sched = xor_schedule.build_schedule(mat)
    xor_schedule.verify_schedule(sched, mat)
    bad_ops = np.array(sched.ops, copy=True)
    xors = np.nonzero(bad_ops[:, 2] == xor_schedule.OP_XOR)[0]
    assert len(xors)
    i = int(xors[-1])
    bad_ops[i, 1] = (bad_ops[i, 1] + 1) % (8 * sched.k)
    bad = xor_schedule.XorSchedule(sched.k, sched.r, sched.n_temps,
                                   np.ascontiguousarray(bad_ops),
                                   sched.raw_xors, sched.digest)
    with pytest.raises(ErasureError, match="miscompile"):
        xor_schedule.verify_schedule(bad, mat)


def test_verifier_rejects_wrong_matrix():
    mat_a = matrix.build_encode_matrix(4, 2)
    mat_b = np.array(mat_a, copy=True)
    mat_b[0, 0] ^= 1
    sched = xor_schedule.build_schedule(mat_a)
    with pytest.raises(ErasureError, match="miscompile"):
        xor_schedule.verify_schedule(sched, mat_b)


def test_verifier_runs_on_every_build_before_caching():
    import unittest.mock as mock

    mat = matrix.build_encode_matrix(3, 2)
    with mock.patch.object(xor_schedule, "verify_schedule",
                           side_effect=AssertionError("called")) as v:
        with pytest.raises(AssertionError, match="called"):
            xor_schedule.build_schedule(mat)
    assert v.called
