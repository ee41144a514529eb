"""The port's native host codec (``chunky_bits_tpu_torch/ops/cpu_backend.py``
over its own ``csrc/gf256.cpp``) against the JAX package's ``NativeBackend``
and the numpy oracle.

The cases of ``tests/test_backends.py`` and ``tests/test_native_hash.py``
run on the port's codec, beside a geometry fuzz (d 1-20, p 0-6, shards of 1
byte to 4 KiB), the SHA engine against hashlib (rows, buffers, file ranges
and short files), ``encode_and_hash_into`` over slices, the ``native:N``
names, every GF and XOR kernel tier forced, the host pipeline's stripe
route at 1-4 workers, and the g++ build itself.  Parity, rebuilt rows and
digests must be equal byte for byte (tolerance 0).  The codec builds here
with g++, as on the card's box.
"""

import asyncio
import hashlib
import os

import numpy as np
import pytest

from chunky_bits_tpu.ops import cpu_backend as jax_native
from chunky_bits_tpu.ops.backend import ErasureCoder as JaxCoder
from chunky_bits_tpu.ops.backend import NumpyBackend as JaxNumpy
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import _build, backend, cpu_backend, matrix
from chunky_bits_tpu_torch.ops.backend import (ErasureCoder, NumpyBackend,
                                               get_backend)
from chunky_bits_tpu_torch.ops.cpu_backend import (NativeBackend,
                                                   sha256_buf, sha256_file,
                                                   sha256_rows)
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
from tests.test_torch_file import bounded, run


def sha(x) -> bytes:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).digest()


def oracle(d, p, data):
    """(parity, digests) from the JAX package's numpy coder."""
    return JaxCoder(d, p, JaxNumpy()).encode_hash_batch(data)


@pytest.fixture
def tiers():
    """Force kernel tiers for one test and restore the detected best (the
    knobs are process-wide in both packages)."""
    yield cpu_backend
    cpu_backend.gf_force_level(2)
    cpu_backend.xor_force_impl(2)


# ---- the SHA engine ----

@pytest.mark.parametrize(
    "n", [0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 128, 1000, 65537])
def test_native_sha256_matches_hashlib(n):
    data = np.random.default_rng(n).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    assert sha256_buf(data) == hashlib.sha256(data).digest()
    assert sha256_buf(data) == jax_native.sha256_buf(data)


@pytest.mark.parametrize("s", [0, 1, 55, 64, 65, 4096, 4097])
@pytest.mark.parametrize("nthreads", [0, 1, 3])
def test_sha256_rows_matches_hashlib(s, nthreads):
    rng = np.random.default_rng(s + 7 * nthreads)
    rows = rng.integers(0, 256, (3, 5, s), dtype=np.uint8)
    out = np.empty((3, 5, 32), dtype=np.uint8)
    sha256_rows(rows, out, nthreads)
    for idx in np.ndindex(3, 5):
        assert out[idx].tobytes() == sha(rows[idx])
    theirs = np.empty_like(out)
    jax_native.sha256_rows(rows, theirs, nthreads)
    assert np.array_equal(out, theirs)
    # a strided input is copied; a strided output is refused (empty rows
    # broadcast sha256(b"") into any output, as in the JAX package)
    part = out[:, :3].copy()
    sha256_rows(rows[:, ::2], part, nthreads)
    assert np.array_equal(part, out[:, ::2])
    if s:
        with pytest.raises(ErasureError, match="contiguous"):
            sha256_rows(rows, np.empty((3, 5, 64), np.uint8)[..., :32])


def test_row_hasher_is_the_native_engine_and_takes_any_output():
    assert backend.row_hasher_engine() == "native"
    hasher = backend.row_hasher()
    rows = np.random.default_rng(3).integers(0, 256, (4, 2, 300),
                                             dtype=np.uint8)
    digests = np.zeros((4, 5, 32), dtype=np.uint8)
    hasher(rows, digests[:, 1:3])  # a strided output, through scratch
    hasher(rows[:, :1], digests[:, 4:], 1)
    for i in range(4):
        assert digests[i, 1].tobytes() == sha(rows[i, 0])
        assert digests[i, 2].tobytes() == sha(rows[i, 1])
        assert digests[i, 4].tobytes() == sha(rows[i, 0])
    assert not digests[:, 0].any() and not digests[:, 3].any()


def test_sha256_file_ranges(tmp_path):
    """Whole files, interior ranges, tails, empty ranges, the padding
    lengths, short files and missing files, as the JAX package's."""
    data = np.random.default_rng(31).integers(
        0, 256, 3 * (1 << 20) + 137, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    p = str(path)
    cases = [(0, None), (100, 5000), (len(data) - 10, None), (0, 0),
             (len(data), None)] + [(0, n) for n in (55, 56, 63, 64, 65, 119,
                                                    128)]
    for start, length in cases:
        end = len(data) if length is None else start + length
        want = hashlib.sha256(data[start:end]).digest()
        assert sha256_file(p, start, length) == want, (start, length)
        assert jax_native.sha256_file(p, start, length) == want
    for start, length in ((0, len(data) + 1), (len(data) - 5, 6)):
        with pytest.raises(OSError, match="short file"):
            sha256_file(p, start, length)
    short = tmp_path / "short.bin"
    short.write_bytes(b"abc")
    with pytest.raises(OSError, match="short file"):
        sha256_file(str(short), 1, 3)
    assert sha256_file(str(short), 1, 2) == hashlib.sha256(b"bc").digest()
    with pytest.raises(OSError):
        sha256_file(str(tmp_path / "missing.bin"))


# ---- the codec across backends (tests/test_backends.py) ----

def _backends():
    return [NumpyBackend(), get_backend("native"), get_backend("native:2"),
            NativeBackend(xor_schedule=True)]


@pytest.mark.parametrize("d,p", [(1, 2), (3, 2), (10, 4), (20, 6)])
def test_encode_identity_across_backends(d, p):
    data = np.random.default_rng(42).integers(0, 256, (3, d, 1000),
                                              dtype=np.uint8)
    want = JaxCoder(d, p, jax_native.NativeBackend()).encode_batch(data)
    assert np.array_equal(want, oracle(d, p, data)[0])
    for be in _backends():
        got = ErasureCoder(d, p, be).encode_batch(data)
        assert np.array_equal(got, want), be.name


@pytest.mark.parametrize("d,p", [(3, 2), (10, 4)])
def test_reconstruct_identity_across_backends(d, p):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (2, d, 512), dtype=np.uint8)
    parity = oracle(d, p, data)[0]
    full = np.concatenate([data, parity], axis=1)
    erased = [int(x) for x in rng.choice(d + p, size=p, replace=False)]
    present = [i for i in range(d + p) if i not in erased]
    theirs = JaxCoder(d, p, jax_native.NativeBackend()).reconstruct_batch(
        full, present, erased)
    for be in _backends():
        rebuilt = ErasureCoder(d, p, be).reconstruct_batch(full, present,
                                                           erased)
        assert np.array_equal(rebuilt, theirs), be.name
        assert np.array_equal(rebuilt, full[:, erased]), be.name


def test_native_large_batch_threads():
    data = np.random.default_rng(3).integers(0, 256, (64, 3, 4096),
                                             dtype=np.uint8)
    got = ErasureCoder(3, 2, get_backend("native")).encode_batch(data)
    assert np.array_equal(got, oracle(3, 2, data)[0])


def test_native_thread_knob_spec():
    """``native:N`` caps the codec's host threads; the results are the
    same bytes, and bad counts are refused as the JAX package refuses
    them."""
    from chunky_bits_tpu.errors import ErasureError as JaxErasureError
    from chunky_bits_tpu.ops.backend import get_backend as jax_get_backend

    be2 = get_backend("native:2")
    assert be2.name == "native:2" and be2.nthreads == 2
    assert get_backend("native:2") is be2
    assert get_backend("native").nthreads == 0
    assert backend.canonical_backend_name("native:2") == "native:2"
    d, p = 5, 3
    data = np.random.default_rng(21).integers(0, 256, (7, d, 2048),
                                              dtype=np.uint8)
    want_p, want_d = oracle(d, p, data)
    parity, digests = ErasureCoder(d, p, be2).encode_hash_batch(data)
    assert np.array_equal(parity, want_p) and np.array_equal(digests, want_d)
    for bad in ("native:", "native:0", "native:-2", "native:x"):
        with pytest.raises(ErasureError, match="thread count"):
            get_backend(bad)
        with pytest.raises(JaxErasureError, match="thread count"):
            jax_get_backend(bad)


@pytest.mark.parametrize("s", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                               4095, 4096, 4097, 32768, 32769, 70000])
def test_native_vector_width_boundaries(s):
    """Shard lengths around the SIMD widths, the SHA block and the 32 KiB
    fusion block, on the encode and the fused encode+hash paths."""
    d, p = 5, 3
    data = np.random.default_rng(s).integers(0, 256, (3, d, s),
                                             dtype=np.uint8)
    want_p, want_d = oracle(d, p, data)
    coder = ErasureCoder(d, p, get_backend("native"))
    assert np.array_equal(coder.encode_batch(data), want_p)
    parity, digests = coder.encode_hash_batch(data)
    assert np.array_equal(parity, want_p)
    assert np.array_equal(digests, want_d)


def test_fused_encode_hash_matches_unfused():
    d, p = 5, 3
    data = np.random.default_rng(7).integers(0, 256, (4, d, 2048),
                                             dtype=np.uint8)
    parity, digests = ErasureCoder(d, p, NativeBackend()).encode_hash_batch(
        data)
    theirs = JaxCoder(d, p, jax_native.NativeBackend()).encode_hash_batch(
        data)
    assert np.array_equal(parity, theirs[0])
    assert np.array_equal(digests, theirs[1])
    for i in range(4):
        for j in range(d):
            assert digests[i, j].tobytes() == sha(data[i, j])
        for j in range(p):
            assert digests[i, d + j].tobytes() == sha(parity[i, j])


def test_encode_hash_zero_parity():
    d = 4
    data = np.random.default_rng(3).integers(0, 256, (2, d, 256),
                                             dtype=np.uint8)
    for be in (NativeBackend(), NativeBackend(xor_schedule=True)):
        parity, digests = ErasureCoder(d, 0, be).encode_hash_batch(data)
        assert parity.shape == (2, 0, 256) and digests.shape == (2, d, 32)
        assert digests[1, 2].tobytes() == sha(data[1, 2])


def test_empty_shapes():
    be = NativeBackend()
    mat = matrix.build_encode_matrix(3, 2)[3:]
    for shape in ((0, 3, 16), (2, 3, 0)):
        data = np.zeros(shape, dtype=np.uint8)
        assert be.apply_matrix(mat, data).shape == (shape[0], 2, shape[2])
        parity, digests = be.encode_and_hash(mat, data)
        want_p, want_d = oracle(3, 2, data)
        assert np.array_equal(parity, want_p)
        assert np.array_equal(digests, want_d)


@pytest.mark.parametrize("seed", range(8))
def test_geometry_fuzz(seed):
    """Random geometries (d 1-20, p 0-6, shards of 1 B to 4 KiB): parity,
    digests and rebuilt rows of the port's codec, table and XOR engines,
    equal the JAX package's native codec and numpy."""
    rng = np.random.default_rng(1000 + seed)
    engines = (NativeBackend(), NativeBackend(nthreads=1, xor_schedule=True))
    for _ in range(4):
        d = int(rng.integers(1, 21))
        p = int(rng.integers(0, 7))
        s = int(rng.choice([int(rng.integers(1, 4097)),
                            8 * int(rng.integers(1, 513))]))
        b = int(rng.integers(1, 4))
        data = rng.integers(0, 256, (b, d, s), dtype=np.uint8)
        want_p, want_d = oracle(d, p, data)
        theirs = JaxCoder(d, p, jax_native.NativeBackend()).encode_hash_batch(
            data)
        assert np.array_equal(theirs[0], want_p)
        assert np.array_equal(theirs[1], want_d)
        full = np.concatenate([data, want_p], axis=1)
        lost = [int(x) for x in rng.choice(d + p, size=p, replace=False)]
        present = [i for i in range(d + p) if i not in lost]
        for be in engines:
            coder = ErasureCoder(d, p, be)
            parity, digests = coder.encode_hash_batch(data)
            assert np.array_equal(parity, want_p), (d, p, s, be._xor)
            assert np.array_equal(digests, want_d), (d, p, s, be._xor)
            if lost:
                rebuilt = coder.reconstruct_batch(full, present, lost)
                assert np.array_equal(rebuilt, full[:, lost]), (d, p, s)


@pytest.mark.parametrize("xor", [False, True])
def test_encode_and_hash_into_over_slices(xor):
    """Each stripe range written into its own rows of shared outputs, as
    the host pipeline slices it, equals the whole call."""
    d, p, s, b = 6, 3, 1024, 7
    data = np.random.default_rng(5).integers(0, 256, (b, d, s),
                                             dtype=np.uint8)
    be = NativeBackend(xor_schedule=xor)
    mat = matrix.build_encode_matrix(d, p)[d:]
    parity = np.full((b, p, s), 0xAA, dtype=np.uint8)
    digests = np.full((b, d + p, 32), 0xAA, dtype=np.uint8)
    for lo, hi in ((0, 2), (2, 3), (3, 7)):
        be.encode_and_hash_into(mat, data[lo:hi], parity[lo:hi],
                                digests[lo:hi], 1)
    want_p, want_d = oracle(d, p, data)
    assert np.array_equal(parity, want_p)
    assert np.array_equal(digests, want_d)
    with pytest.raises(ErasureError, match="contiguous"):
        be.encode_and_hash_into(mat, data, parity, digests[:, ::-1])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_every_gf_tier_forced(tiers, level):
    """The byte-table kernels at each tier (scalar, AVX2 pshufb, GFNI;
    clamped to what this CPU has) give the same bytes, and so do the JAX
    package's at the same tier."""
    got = tiers.gf_force_level(level)
    assert 0 <= got <= level
    assert jax_native.gf_force_level(level) == got
    try:
        for d, p, s in ((10, 4, 4096), (3, 2, 77), (20, 6, 1000)):
            data = np.random.default_rng(s + level).integers(
                0, 256, (3, d, s), dtype=np.uint8)
            want_p, want_d = oracle(d, p, data)
            be = NativeBackend()
            parity, digests = ErasureCoder(d, p, be).encode_hash_batch(data)
            assert np.array_equal(parity, want_p), (got, d, p, s)
            assert np.array_equal(digests, want_d), (got, d, p, s)
            theirs = JaxCoder(d, p, jax_native.NativeBackend()).encode_batch(
                data)
            assert np.array_equal(theirs, want_p)
    finally:
        jax_native.gf_force_level(2)
    assert cpu_backend.native_tiers()["gf"] == got


@pytest.mark.parametrize("level", [0, 1, 2])
def test_every_xor_tier_forced(tiers, level):
    got = tiers.xor_force_impl(level)
    assert 0 <= got <= level
    be = NativeBackend(xor_schedule=True)
    for d, p, s in ((10, 4, 4096), (5, 3, 8), (20, 6, 1000)):
        data = np.random.default_rng(s + level).integers(
            0, 256, (2, d, s), dtype=np.uint8)
        want_p, want_d = oracle(d, p, data)
        parity, digests = ErasureCoder(d, p, be).encode_hash_batch(data)
        assert np.array_equal(parity, want_p), (got, d, p, s)
        assert np.array_equal(digests, want_d), (got, d, p, s)
    assert cpu_backend.native_tiers()["xor"] == got


# ---- the host pipeline's stripe route ----

@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["native", "native:2"])
def test_host_pipeline_stripe_route_equals_one_thread(workers, name):
    """Stripes sliced over 1-4 workers (each fused pass with nthreads=1,
    capped by ``native:N``) give the bytes of the one-thread path; one
    stripe, p = 0 and pm-msr take the row route, with the same bytes."""
    be = get_backend(name)
    pipe = HostPipeline(threads=workers)
    one = HostPipeline(threads=1)
    try:
        rng = np.random.default_rng(workers)
        for d, p, b, s in ((10, 4, 9, 1024), (3, 2, 1, 333), (4, 0, 5, 64)):
            data = rng.integers(0, 256, (b, d, s), dtype=np.uint8)
            coder = ErasureCoder(d, p, be)
            got = pipe.encode_hash_sync(coder, data)
            want = one.encode_hash_sync(coder, data)
            theirs = oracle(d, p, data)
            for g, w, t in zip(got, want, theirs):
                assert np.array_equal(g, w) and np.array_equal(g, t)
        from chunky_bits_tpu_torch.ops.backend import get_coder

        msr = get_coder(5, 4, name, "pm-msr")
        data = rng.integers(0, 256, (3, 5, 4 * 256), dtype=np.uint8)
        got = pipe.encode_hash_sync(msr, data)
        want = get_coder(5, 4, "numpy", "pm-msr").encode_hash_batch(data)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        stages = {st.stage: st for st in pipe.stats().stages}
        assert stages["encode"].jobs > 0
    finally:
        pipe.close()
        one.close()


def test_host_pipeline_caps_workers_at_native_n(monkeypatch):
    """``native:2`` on a 4-worker pipeline slices 9 stripes into 2 jobs."""
    pipe = HostPipeline(threads=4)
    seen = []
    real = NativeBackend.encode_and_hash_into

    def spy(self, mat, shards, *args):
        seen.append(shards.shape[0])
        return real(self, mat, shards, *args)

    monkeypatch.setattr(NativeBackend, "encode_and_hash_into", spy)
    try:
        data = np.random.default_rng(1).integers(0, 256, (9, 10, 256),
                                                 dtype=np.uint8)
        got = pipe.encode_hash_sync(ErasureCoder(10, 4,
                                                 get_backend("native:2")),
                                    data)
        assert sorted(seen) == [4, 5]
        assert np.array_equal(got[1], oracle(10, 4, data)[1])
    finally:
        pipe.close()


# ---- the object codec on the native backend ----

def test_writer_hashes_match_persisted_bytes(tmp_path):
    """Every chunk hash of a reference written on ``native`` is the
    SHA-256 of the bytes stored at its location, and equals the JAX
    package's reference for the same stream."""
    import chunky_bits_tpu.file as jfile
    from chunky_bits_tpu.utils import aio as jaio
    from chunky_bits_tpu_torch.file import (FileWriteBuilder,
                                            LocationsDestination)
    from chunky_bits_tpu_torch.file.location import Location
    from chunky_bits_tpu_torch.utils import aio

    payload = np.random.default_rng(29).integers(
        0, 256, 3 * 4096 * 3 + 123, dtype=np.uint8).tobytes()

    async def main():
        dirs = []
        for i in range(5):
            (tmp_path / f"d{i}").mkdir()
            dirs.append(Location.parse(str(tmp_path / f"d{i}")))
        ref = await (FileWriteBuilder().with_chunk_size(4096)
                     .with_data_chunks(3).with_parity_chunks(2)
                     .with_batch_parts(4).with_backend("native")
                     .with_destination(LocationsDestination(dirs))
                     .write(aio.BytesReader(payload)))
        theirs = await (jfile.FileWriteBuilder().with_chunk_size(4096)
                        .with_data_chunks(3).with_parity_chunks(2)
                        .with_batch_parts(4).with_backend("native")
                        .write(jaio.BytesReader(payload)))
        n = 0
        for part in ref.parts:
            for chunk in part.all_chunks():
                stored = await chunk.locations[0].read()
                assert str(chunk.hash) == \
                    f"sha256-{hashlib.sha256(stored).hexdigest()}"
                n += 1
        assert n == 4 * 5
        assert [str(c.hash) for part in ref.parts
                for c in part.all_chunks()] == \
            [str(c.hash) for part in theirs.parts for c in part.all_chunks()]

    run(main())


def test_verify_uses_the_fused_file_hash(tmp_path, monkeypatch):
    """``verify`` hashes local chunks through the native read+hash pass
    (no bytes reach Python) and still finds a flipped byte; with a
    profiler attached it takes the generic read."""
    from chunky_bits_tpu_torch.file import (FileWriteBuilder,
                                            LocationsDestination)
    from chunky_bits_tpu_torch.file.location import (Location,
                                                     LocationContext)
    from chunky_bits_tpu_torch.file.profiler import new_profiler
    from chunky_bits_tpu_torch.utils import aio

    calls = []

    def counting(path, start=0, length=None):
        calls.append(path)
        return sha256_file(path, start, length)

    monkeypatch.setattr(cpu_backend, "sha256_file", counting)
    payload = np.random.default_rng(23).integers(
        0, 256, 60000, dtype=np.uint8).tobytes()
    dirs = []
    for i in range(5):
        (tmp_path / f"disk{i}").mkdir()
        dirs.append(Location.parse(str(tmp_path / f"disk{i}")))

    async def main():
        ref = await (FileWriteBuilder().with_backend("native")
                     .with_destination(LocationsDestination(dirs))
                     .with_chunk_size(4096)
                     .write(aio.BytesReader(payload)))
        report = await ref.verify()
        assert report.integrity().name == "VALID"
        fused = len(calls)
        assert fused == sum(len(c.locations) for part in ref.parts
                            for c in part.all_chunks())
        target = ref.parts[0].data[1].locations[0].target
        with open(target, "r+b") as f:
            raw = f.read(1)
            f.seek(0)
            f.write(bytes([raw[0] ^ 0xFF]))
        report = await ref.verify()
        assert report.integrity().name == "DEGRADED"
        cx = LocationContext(profiler=new_profiler()[0])
        report = await ref.verify(cx)
        assert report.integrity().name == "DEGRADED"
        assert len(calls) == 2 * fused  # the profiled verify read instead

    bounded(lambda: asyncio.run(main()))


# ---- the build ----

def test_host_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    """A fresh build directory gets one library named by the source, the
    flags and this CPU; a source that does not compile raises
    ``ErasureError`` with g++'s output and leaves no file behind."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "b"))
    path = _build.host_library()
    assert os.path.dirname(path) == str(tmp_path / "b")
    assert os.path.basename(path).startswith("libcbgf-")
    assert _build.HOST_BUILD["flags"].startswith("-march=native")
    assert _build.host_library() == path
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        [".host.lock", os.path.basename(path)])
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SOURCE", str(bad))
    with pytest.raises(ErasureError, match="failed to build"):
        _build.host_library()
    assert len(_build.HOST_BUILD["log"]) == 2  # with and without -march
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        [".host.lock", os.path.basename(path)])


def test_failed_build_raises_and_only_the_row_hasher_stands_in(
        monkeypatch):
    """Where the codec cannot build, ``native`` raises ``ErasureError``
    (no numpy stand-in), and the row hasher alone takes hashlib, with the
    same digests, and says so."""
    def broken():
        raise ErasureError("failed to build the native gf256 codec: g++")

    monkeypatch.setattr(_build, "host_library", broken)
    monkeypatch.setattr(cpu_backend, "_LIB", None)
    monkeypatch.setattr(backend, "_ROW_HASHER", None)
    monkeypatch.setattr(backend, "_REGISTRY", {})
    with pytest.raises(ErasureError, match="failed to build"):
        NativeBackend()
    with pytest.raises(ErasureError, match="failed to build"):
        get_backend("native:3")
    assert backend.row_hasher_engine() == "hashlib"
    rows = np.random.default_rng(2).integers(0, 256, (2, 3, 100),
                                             dtype=np.uint8)
    out = np.empty((2, 3, 32), dtype=np.uint8)
    backend.row_hasher()(rows, out, 1)
    assert out[1, 2].tobytes() == sha(rows[1, 2])


def test_sizes_are_checked_before_native_calls():
    """The C entry points trust their sizes, so a mismatched matrix,
    output or digest buffer is refused in Python."""
    be = NativeBackend()
    mat = np.ones((2, 3), dtype=np.uint8)
    with pytest.raises(ErasureError, match="does not apply"):
        be.apply_matrix(mat, np.zeros((1, 4, 8), dtype=np.uint8))
    data = np.zeros((1, 3, 8), dtype=np.uint8)
    with pytest.raises(ErasureError, match="do not fit"):
        be.encode_and_hash_into(mat, data, np.zeros((1, 2, 8), np.uint8),
                                np.zeros((1, 4, 32), np.uint8))
    with pytest.raises(ErasureError, match="96 bytes"):
        sha256_rows(np.zeros((3, 8), np.uint8), np.zeros((2, 32), np.uint8))
