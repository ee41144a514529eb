"""The port's randomized conformance sweep, the mirror of
``tests/test_conformance_fuzz.py``: the same test names, seeds and sizes.

Seeded random geometries with adversarial lengths (stripe-aligned,
off-by-one, sub-stripe, empty tail) and random erasure patterns go
through the port's backends where the reference names its own: ``numpy``,
``native`` and ``torch`` (the kernels' plain versions) where it names
``numpy`` and ``native``; the ``mesh`` backend and an explicit
``cuda:<spec>`` mesh over ``virtual_devices(8, "cpu")`` where it names
``jax`` or ``mesh``.  Each case also holds the port against the JAX
package on the same input: parity against its ``NumpyBackend``, pm-msr
projections and repairs against its ``PMMSRCoder``, and the slab/path
objects read back through the other package.  Tolerance 0 throughout.

Each case runs under ``bounded``, so a hang fails one test instead of
cutting the suite.  Cases 0, 1 and 3 of
``test_pm_msr_xor_schedule_conformance`` (k=6 with p=6, 8 and 5)
are marked ``slow``: building their XOR schedules takes 47-92 s each on
a CPU host in both packages, since the port's common-subexpression pass
is the reference's, kept so the schedules stay identical
(``tests/test_torch_xor_schedule.py``).
"""

import asyncio
import os

import numpy as np
import pytest

from chunky_bits_tpu.ops.backend import ErasureCoder as JErasureCoder
from chunky_bits_tpu.ops.backend import NumpyBackend as JNumpyBackend
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops.backend import (ErasureCoder, NumpyBackend,
                                               get_backend)
from chunky_bits_tpu_torch.utils import virtualmesh
from tests.test_torch_file import bounded

#: seconds the slow case may take before it fails
SLOW_TIMEOUT = 900

ORACLE = JNumpyBackend()


def _native_or_skip():
    try:
        return get_backend("native")
    except Exception as err:  # pragma: no cover - no compiler in env
        pytest.skip(f"native backend unavailable: {err}")


def _host_backends():
    """The port's backends in the reference's ``numpy``/``native`` places."""
    return [NumpyBackend(), _native_or_skip(), get_backend("torch")]


def _cpu_meshes(k):
    """The port's mesh backends over 8 logical CPU devices for stripes of
    width ``k``: ``mesh`` (a layout per dispatch) and an explicit mesh,
    the ``dp2,tp4`` stripe mesh (K2's plain version and the tp
    reduce-and-pack) where 4 divides ``k``, else ``dp4,sp2``."""
    from chunky_bits_tpu_torch.ops.mesh_backend import MeshBackend
    from chunky_bits_tpu_torch.parallel.backend import MeshCudaBackend

    cpu8 = virtualmesh.virtual_devices(8, "cpu")
    spec = "dp2,tp4" if k % 4 == 0 else "dp4,sp2"
    return [MeshBackend(devices=cpu8), MeshCudaBackend(spec, devices=cpu8)]


def _reference_parity(d, p, data):
    return JErasureCoder(d, p, ORACLE).encode_batch(data)


@pytest.mark.parametrize("seed", range(8))
def test_random_geometry_roundtrip(seed):
    def body():
        rng = np.random.default_rng(seed)
        d = int(rng.integers(1, 17))
        p = int(rng.integers(0, 9))
        size = int(rng.integers(1, 3000))
        batch = int(rng.integers(1, 5))

        data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
        coders = [ErasureCoder(d, p, be) for be in _host_backends()]
        parity = _reference_parity(d, p, data)
        for coder in coders:
            assert np.array_equal(coder.encode_batch(data), parity), \
                coder.backend.name

        if p == 0:
            return
        full = np.concatenate([data, parity], axis=1)

        for _ in range(4):
            n_erase = int(rng.integers(1, p + 1))
            erased = rng.choice(d + p, size=n_erase, replace=False)
            shards = [None if i in erased else full[0, i]
                      for i in range(d + p)]
            for coder in coders:
                out = coder.reconstruct(list(shards))
                for i in range(d + p):
                    assert np.array_equal(out[i], full[0, i]), \
                        (d, p, erased, i, coder.backend.name)

    bounded(body)


@pytest.mark.parametrize("seed", range(6))
def test_xor_schedule_conformance(seed):
    """The scheduled-XOR engine (numpy executor and the native
    ``cb_xor_exec``) against the JAX package's parity, and its
    reconstructions on the decode route the batchers dispatch through."""
    from chunky_bits_tpu_torch.ops import xor_schedule

    def body():
        rng = np.random.default_rng(500 + seed)
        d = int(rng.integers(1, 17))
        p = int(rng.integers(1, 9))
        size = int(rng.integers(1, 300)) * 8
        batch = int(rng.integers(1, 4))

        data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
        try:
            from chunky_bits_tpu_torch.ops.cpu_backend import NativeBackend

            xor_coder = ErasureCoder(d, p, NativeBackend(xor_schedule=True))
        except Exception as err:  # pragma: no cover - no compiler in env
            pytest.skip(f"native backend unavailable: {err}")

        parity = _reference_parity(d, p, data)
        assert np.array_equal(parity, xor_coder.encode_batch(data))
        sched = xor_schedule.get_schedule(xor_coder.parity_rows)
        assert np.array_equal(parity, xor_schedule.apply_numpy(sched, data))

        full = np.concatenate([data, parity], axis=1)
        for _ in range(4):
            n_erase = int(rng.integers(1, p + 1))
            erased = rng.choice(d + p, size=n_erase, replace=False)
            shards = [None if i in erased else full[0, i]
                      for i in range(d + p)]
            out = xor_coder.reconstruct(list(shards))
            for i in range(d + p):
                assert np.array_equal(out[i], full[0, i]), (d, p, erased, i)

    bounded(body)


def _pm_geometry(rng):
    """A random geometry pm-msr supports: k >= 2, p >= k-1."""
    k = int(rng.integers(2, 7))
    p = int(rng.integers(k - 1, k + 3))
    return k, p


def _pm_reference(k, p):
    from chunky_bits_tpu.ops.pm_msr import PMMSRCoder as JPMMSRCoder

    return JPMMSRCoder(k, p, ORACLE)


def _pm_check_coder(coder, oracle, full, k, p, erasures, failures):
    """``coder`` against the JAX package's ``oracle`` on ``full``:
    reconstructions of each erasure pattern, then for each (failed,
    helpers) the helper projections and the regenerated chunk."""
    for erased in erasures:
        shards = [None if i in erased else full[0, i] for i in range(k + p)]
        out = coder.reconstruct(list(shards))
        for i in range(k + p):
            assert np.array_equal(out[i], full[0, i]), \
                (k, p, erased, i, coder.backend.name)
    for failed, helpers in failures:
        projs = np.stack([coder.project_batch(failed, full[:, h, :])
                          for h in helpers], axis=1)
        theirs = np.stack([oracle.project_batch(failed, full[:, h, :])
                           for h in helpers], axis=1)
        assert np.array_equal(projs, theirs), coder.backend.name
        regen = coder.repair_batch(failed, helpers, projs)
        assert np.array_equal(regen, full[:, failed, :]), \
            (k, p, failed, coder.backend.name)
        assert np.array_equal(oracle.repair_batch(failed, helpers, projs),
                              regen)


@pytest.mark.parametrize("seed", range(8))
def test_pm_msr_conformance(seed):
    """Product-matrix MSR: parity, reconstructions, helper projections
    and regenerated chunks on each host backend, against the JAX
    package's ``PMMSRCoder`` and the original data."""
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    def body():
        rng = np.random.default_rng(900 + seed)
        k, p = _pm_geometry(rng)
        alpha, dh = k - 1, 2 * (k - 1)
        size = int(rng.integers(1, 400)) * alpha
        batch = int(rng.integers(1, 4))

        data = rng.integers(0, 256, (batch, k, size), dtype=np.uint8)
        oracle = _pm_reference(k, p)
        coders = [PMMSRCoder(k, p, be) for be in _host_backends()]

        parity = oracle.encode_batch(data)
        for coder in coders:
            assert np.array_equal(parity, coder.encode_batch(data)), \
                coder.backend.name
        full = np.concatenate([data, parity], axis=1)

        erasures = [rng.choice(k + p, size=int(rng.integers(1, p + 1)),
                               replace=False) for _ in range(4)]
        failures = []
        for _ in range(3):
            failed = int(rng.integers(0, k + p))
            others = [i for i in range(k + p) if i != failed]
            helpers = sorted(rng.permutation(others)[:dh].tolist())
            failures.append((failed, helpers))
        for coder in coders:
            _pm_check_coder(coder, oracle, full, k, p, erasures, failures)
        # each helper ships beta = size/alpha bytes: dh*beta = 2*size
        failed, helpers = failures[0]
        projs = np.stack([coders[0].project_batch(failed, full[:, h, :])
                          for h in helpers], axis=1)
        assert projs.shape == (batch, dh, size // alpha)

    bounded(body)


def _xor_case(seed, slow=False):
    marks = (pytest.mark.slow,) if slow else ()
    return pytest.param(seed, marks=marks, id=str(seed))


@pytest.mark.parametrize("seed", [_xor_case(0, slow=True),
                                  _xor_case(1, slow=True), _xor_case(2),
                                  _xor_case(3, slow=True)])
def test_pm_msr_xor_schedule_conformance(seed):
    """Every pm-msr apply (encode, decode, projection, repair combine)
    through the scheduled-XOR engine, against the JAX package's
    ``PMMSRCoder``: the route a ``CHUNKY_BITS_TORCH_XOR_SCHEDULE=1``
    host runs repair on."""
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    def body():
        rng = np.random.default_rng(950 + seed)
        k, p = _pm_geometry(rng)
        alpha, dh = k - 1, 2 * (k - 1)
        # plane-eligible sub-stripe lengths (S/alpha % 8 == 0) so the
        # engine runs rather than falling back to the table path
        size = int(rng.integers(1, 60)) * 8 * alpha
        data = rng.integers(0, 256, (2, k, size), dtype=np.uint8)
        oracle = _pm_reference(k, p)
        try:
            from chunky_bits_tpu_torch.ops.cpu_backend import NativeBackend

            xor = PMMSRCoder(k, p, NativeBackend(xor_schedule=True))
        except Exception as err:  # pragma: no cover - no compiler in env
            pytest.skip(f"native backend unavailable: {err}")

        parity = oracle.encode_batch(data)
        assert np.array_equal(parity, xor.encode_batch(data))
        full = np.concatenate([data, parity], axis=1)
        erased = rng.choice(k + p, size=p, replace=False)
        failed = int(rng.integers(0, k + p))
        helpers = [i for i in range(k + p) if i != failed][:dh]
        _pm_check_coder(xor, oracle, full, k, p, [erased],
                        [(failed, helpers)])

    bounded(body, SLOW_TIMEOUT)


def test_pm_msr_jax_conformance():
    """The reference's device-backend leg: pm-msr through the port's
    device routes on the CPU (``torch``, the kernels' plain versions, and
    an explicit mesh over 8 logical devices), against the JAX package's
    ``PMMSRCoder``."""
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    def body():
        k, p = 3, 2
        alpha = k - 1
        rng = np.random.default_rng(1000)
        size = 64 * alpha
        data = rng.integers(0, 256, (2, k, size), dtype=np.uint8)
        oracle = _pm_reference(k, p)
        parity = oracle.encode_batch(data)
        full = np.concatenate([data, parity], axis=1)
        for be in [get_backend("torch"), _cpu_meshes(k)[1]]:
            coder = PMMSRCoder(k, p, be)
            assert np.array_equal(parity, coder.encode_batch(data)), be.name
            _pm_check_coder(coder, oracle, full, k, p, [(0, 4)],
                            [(0, [1, 2, 3, 4])])

    bounded(body)


@pytest.mark.parametrize("seed", range(6))
def test_mesh_backend_conformance(seed):
    """The multi-device leg: random geometry, adversarial lengths and
    erasure patterns through ``mesh`` (a layout per dispatch) and an
    explicit mesh on 8 logical CPU devices, against the JAX package's
    parity (encode and the reconstruct decode route)."""
    def body():
        rng = np.random.default_rng(1600 + seed)
        d = int(rng.integers(1, 17))
        p = int(rng.integers(1, 9))
        # adversarial lengths: sub-lane, off-by-one and mesh-indivisible
        size = int(rng.choice([1, 63, 65, int(rng.integers(1, 3000))]))
        batch = int(rng.integers(1, 6))  # incl. batches that don't divide 8

        data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
        coders = [ErasureCoder(d, p, be) for be in _cpu_meshes(d)]
        parity = _reference_parity(d, p, data)
        for coder in coders:
            assert np.array_equal(parity, coder.encode_batch(data)), \
                (d, p, size, batch, coder.backend.name)
        full = np.concatenate([data, parity], axis=1)

        for _ in range(4):
            n_erase = int(rng.integers(1, p + 1))
            erased = rng.choice(d + p, size=n_erase, replace=False)
            shards = [None if i in erased else full[0, i]
                      for i in range(d + p)]
            for coder in coders:
                out = coder.reconstruct(list(shards))
                for i in range(d + p):
                    assert np.array_equal(out[i], full[0, i]), \
                        (d, p, erased, i, coder.backend.name)

    bounded(body)


def test_pm_msr_mesh_conformance():
    """pm-msr through the ``mesh`` backend on 8 logical CPU devices:
    parity, reconstruction, helper projections and regeneration against
    the JAX package's ``PMMSRCoder``."""
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    def body():
        k, p = 5, 4
        alpha = k - 1
        rng = np.random.default_rng(1700)
        size = 64 * alpha
        data = rng.integers(0, 256, (2, k, size), dtype=np.uint8)
        oracle = _pm_reference(k, p)
        coder = PMMSRCoder(k, p, _cpu_meshes(k)[0])
        parity = oracle.encode_batch(data)
        assert np.array_equal(parity, coder.encode_batch(data))
        full = np.concatenate([data, parity], axis=1)
        _pm_check_coder(coder, oracle, full, k, p, [(1, 6)],
                        [(1, [0, 2, 3, 4, 5, 6, 7, 8])])

    bounded(body)


@pytest.mark.parametrize("seed", range(3))
def test_pm_msr_rejections(seed):
    """The failure surface: unsupported geometry, unknown code names,
    too-few helpers, and non-alpha-divisible stripe lengths all raise
    ErasureError, never wrong bytes, where the JAX package raises too."""
    from chunky_bits_tpu.errors import ErasureError as JErasureError
    from chunky_bits_tpu.ops.pm_msr import PMMSRCoder as JPMMSRCoder
    from chunky_bits_tpu.ops.pm_msr import geometry_error as jgeometry_error
    from chunky_bits_tpu_torch.ops.backend import get_coder
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder, geometry_error

    def body():
        # parity below the helper budget
        assert geometry_error(5, 3) is not None
        assert jgeometry_error(5, 3) is not None
        with pytest.raises(ErasureError):
            PMMSRCoder(5, 3, NumpyBackend())
        # k=1 has no sub-symbol structure
        with pytest.raises(ErasureError):
            PMMSRCoder(1, 2, NumpyBackend())
        with pytest.raises(JErasureError):
            JPMMSRCoder(1, 2, ORACLE)
        with pytest.raises(ErasureError):
            get_coder(3, 2, "numpy", code="no-such-code")

        rng = np.random.default_rng(1100 + seed)
        k, p = _pm_geometry(rng)
        if k < 3:
            k, p = 3, 2  # alpha >= 2 so indivisible lengths exist
        coder = PMMSRCoder(k, p, NumpyBackend())
        bad = rng.integers(0, 256, (1, k, (k - 1) * 8 + 1), dtype=np.uint8)
        with pytest.raises(ErasureError):
            coder.encode_batch(bad)
        good = rng.integers(0, 256, (1, k, (k - 1) * 8), dtype=np.uint8)
        parity = coder.encode_batch(good)
        assert np.array_equal(parity,
                              JPMMSRCoder(k, p, ORACLE).encode_batch(good))
        full = np.concatenate([good, parity], axis=1)
        with pytest.raises(ErasureError):
            coder.repair_matrix(0, list(range(1, 2 * (k - 1))))  # short
        with pytest.raises(ErasureError):
            coder.repair_matrix(0, [0] + list(range(2, 2 * (k - 1) + 1)))
        # projections stacked for the wrong helper count are refused too
        helpers = list(range(1, 2 * (k - 1) + 1))
        projs = np.stack([coder.project_batch(0, full[:, h, :])
                          for h in helpers], axis=1)
        with pytest.raises(ErasureError):
            coder.repair_batch(0, helpers, projs[:, :-1, :])

    bounded(body)


@pytest.mark.parametrize("seed", range(4))
def test_too_many_erasures_raise(seed):
    """More than p erasures raise on every host backend, as in the JAX
    package, and never return bytes."""
    from chunky_bits_tpu.errors import ErasureError as JErasureError

    def body():
        rng = np.random.default_rng(100 + seed)
        d = int(rng.integers(2, 9))
        p = int(rng.integers(1, 5))
        size = 257
        data = rng.integers(0, 256, (1, d, size), dtype=np.uint8)
        full = np.concatenate([data, _reference_parity(d, p, data)], axis=1)

        erased = rng.choice(d + p, size=p + 1, replace=False)
        shards = [None if i in erased else full[0, i] for i in range(d + p)]
        with pytest.raises(JErasureError):
            JErasureCoder(d, p, ORACLE).reconstruct(list(shards))
        for be in _host_backends():
            with pytest.raises(ErasureError):
                ErasureCoder(d, p, be).reconstruct(list(shards))

    bounded(body)


@pytest.mark.parametrize("seed", range(4))
def test_slab_vs_path_storage_roundtrip_fuzz(seed, tmp_path, monkeypatch):
    """Storage-plane conformance: seeded random geometry/length objects
    written through a packed (``slab:``) cluster and a path cluster give
    identical content addresses, read back byte-identically, and after a
    random reconstructible erasure of packed extents still decode to the
    same bytes.  Each package also reads back every object the other
    wrote, and both give the same content addresses."""
    from chunky_bits_tpu.cluster import Cluster as JCluster
    from chunky_bits_tpu.utils import aio as jaio
    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.utils import aio

    # the spec names no backend, as the reference's does: the port's
    # default is the card, so the CPU runs the kernels' plain versions
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    rng = np.random.default_rng(300 + seed)
    d = int(rng.integers(2, 7))
    p = int(rng.integers(1, 4))
    chunk_log2 = int(rng.integers(10, 14))
    stripe = d * (1 << chunk_log2)
    length = int(rng.choice([1, stripe - 1, stripe, stripe + 1,
                             3 * stripe + 17]))
    payload = rng.integers(0, 256, length, dtype=np.uint8).tobytes()

    def spec(sub: str, packed: bool) -> dict:
        dirs = []
        for i in range(d + p + 1):
            path = os.path.join(str(tmp_path), sub, f"disk{i}")
            os.makedirs(path, exist_ok=True)
            dirs.append(f"slab:{path}" if packed else path)
        meta = os.path.join(str(tmp_path), sub, "meta")
        os.makedirs(meta, exist_ok=True)
        return {
            "destinations": [{"location": x} for x in dirs],
            "metadata": {"type": "path", "format": "yaml", "path": meta},
            "profiles": {"default": {"data": d, "parity": p,
                                     "chunk_size": chunk_log2}},
        }

    def hashes_of(ref) -> list:
        return [str(c.hash) for part in ref.parts
                for c in part.data + part.parity]

    async def write_read(cls, reader_cls, sub, packed):
        cluster = cls.from_obj(spec(sub, packed))
        await cluster.write_file("obj", reader_cls(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("obj")
        assert await cluster.file_read_builder(ref).read_all() == payload, \
            (d, p, chunk_log2, length, packed, sub)
        return cluster, ref

    async def run(packed: bool):
        kind = "slab" if packed else "files"
        cluster, ref = await write_read(Cluster, aio.BytesReader, kind,
                                        packed)
        # the JAX package reads what the port wrote, and the port what the
        # JAX package wrote (into clusters of their own)
        other = JCluster.from_obj(spec(kind, packed))
        jref = await other.get_file_ref("obj")
        assert await other.file_read_builder(jref).read_all() == payload
        _, jwritten = await write_read(JCluster, jaio.BytesReader,
                                       f"{kind}-jax", packed)
        back = Cluster.from_obj(spec(f"{kind}-jax", packed))
        bref = await back.get_file_ref("obj")
        assert await back.file_read_builder(bref).read_all() == payload
        assert hashes_of(jwritten) == hashes_of(ref) == hashes_of(jref)
        if packed:
            # random reconstructible erasure: up to p extents per part
            for part in ref.parts:
                chunks = part.data + part.parity
                n_erase = int(rng.integers(1, p + 1))
                for ci in rng.choice(len(chunks), size=n_erase,
                                     replace=False):
                    await chunks[int(ci)].locations[0].delete()
            got = await cluster.file_read_builder(ref).read_all()
            assert got == payload, \
                f"post-erasure decode mismatch (d={d} p={p})"
        return hashes_of(ref)

    packed_hashes = bounded(lambda: asyncio.run(run(True)))
    plain_hashes = bounded(lambda: asyncio.run(run(False)))
    assert packed_hashes == plain_hashes


def test_adversarial_lengths():
    """Stripe-edge lengths through the part codec's split/pad math
    (reference round-up semantics, src/file/file_part.rs:150-158), shard
    for shard equal to the JAX package's split."""
    from chunky_bits_tpu.file.file_part import \
        split_into_shards as jsplit_into_shards
    from chunky_bits_tpu_torch.file.file_part import split_into_shards

    def body():
        for d in (1, 2, 3, 5, 8):
            for length in (0, 1, d - 1, d, d + 1, 2 * d, 7 * d + 3, 1024):
                if length < 0:
                    continue
                buf = bytes(range(256)) * ((length // 256) + 1)
                buf = buf[:length]
                shards, shard_len = split_into_shards(buf, length, d)
                assert shard_len == (length + d - 1) // d
                joined = b"".join(bytes(s) for s in shards)
                assert joined[:length] == buf
                assert all(b == 0 for b in joined[length:])
                theirs, their_len = jsplit_into_shards(buf, length, d)
                assert their_len == shard_len
                assert [bytes(s) for s in theirs] == \
                    [bytes(s) for s in shards]

    bounded(body)
