"""The port's multi-device compute plane against the JAX package's.

Over ``virtual_devices(8, "cpu")`` (the counterpart of the 8 virtual CPU
devices ``tests/conftest.py`` gives JAX): ``plan_layout``; the mesh
functions (``sharded_apply`` over dp/sp, ``encode_step_sharded`` with its
checksum, ``wide_apply_sharded`` over dp/tp at d=20 p=6, encode and
decode) held against the JAX functions on the JAX virtual mesh and the
numpy oracle; K2's plain version against ``acc_m2_bitmajor`` in interpret
mode, element for element, and against ``bitplane_acc`` at odd S; both
mesh backends (``mesh`` and ``cuda:<spec>``), the batcher's feed-ahead
route and an object round trip at d=20 p=6 between the packages.
Tolerance 0 throughout: integer arithmetic.  The carried-over assertions
come from ``tests/test_mesh_backend.py`` and ``tests/test_parallel.py``.
"""

import asyncio
import itertools
import threading

import numpy as np
import pytest
import torch

import chunky_bits_tpu.file as jfile
from chunky_bits_tpu.ops import matrix as jmatrix
from chunky_bits_tpu.ops import mesh_backend as jmesh_backend
from chunky_bits_tpu.ops.backend import NumpyBackend
from chunky_bits_tpu.parallel import backend as jparallel_backend
from chunky_bits_tpu.utils import aio as jaio
from chunky_bits_tpu_torch.cluster import tunables
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import backend, gf_kernel, mesh_backend
from chunky_bits_tpu_torch.ops.backend import ErasureCoder
from chunky_bits_tpu_torch.ops.batching import EncodeHashBatcher
from chunky_bits_tpu_torch.parallel import backend as parallel_backend
from chunky_bits_tpu_torch.parallel import mesh
from chunky_bits_tpu_torch.utils import virtualmesh

#: seconds a test may wait on an event loop: a hang fails the test
TIMEOUT = 60

CPU8 = virtualmesh.virtual_devices(8, "cpu")
ORACLE = NumpyBackend()


def _data(b, d, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, d, s),
                                                dtype=np.uint8)


def _jax_devices():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return jax.devices()


def bounded(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread, failed after ``timeout`` seconds."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as err:
            box["err"] = err

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), f"still running after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


# ------------------------------------------------------------- plan_layout

def test_plan_layout_equals_jax_on_a_grid():
    assert mesh_backend.WIDE_STRIPE_MIN_K == jmesh_backend.WIDE_STRIPE_MIN_K
    assert mesh_backend.LANE == jmesh_backend.LANE
    for n, b, k, s in itertools.product((1, 2, 3, 4, 6, 8), range(0, 18),
                                        (1, 4, 10, 16, 20, 24),
                                        (1, 63, 777, 4096, 4097)):
        ours = mesh_backend.plan_layout(n, b, k, s)
        theirs = jmesh_backend.plan_layout(n, b, k, s)
        assert (ours.wide, ours.dp, ours.minor, ours.pad_s) == (
            theirs.wide, theirs.dp, theirs.minor, theirs.pad_s), (n, b, k, s)


def test_plan_layout_cases():
    lay = mesh_backend.plan_layout(8, 16, 10, 4096)
    assert (lay.wide, lay.dp, lay.minor, lay.pad_s) == (False, 8, 1, 0)
    lay = mesh_backend.plan_layout(8, 6, 10, 4096)  # 6 does not divide 8
    assert lay.dp == 4 and lay.minor == 2
    lay = mesh_backend.plan_layout(8, 2, 20, 4096)  # config 5 at b=2
    assert lay.wide and (lay.dp, lay.minor, lay.pad_s) == (2, 4, 0)
    lay = mesh_backend.plan_layout(8, 2, 4, 4096)   # narrow: never wide
    assert not lay.wide and lay.minor == 4
    assert mesh_backend.plan_layout(8, 8, 10, 777).pad_s == 0
    assert mesh_backend.plan_layout(8, 0, 10, 4096).dp == 1


@pytest.mark.parametrize("s", [1, 63, 777, 4096, 4097])
def test_plan_layout_sp_slices_stay_lane_aligned(s):
    lay = mesh_backend.plan_layout(8, 2, 10, s)
    assert not lay.wide and lay.minor > 1
    padded = s + lay.pad_s
    assert padded % lay.minor == 0
    assert (padded // lay.minor) % mesh_backend.LANE == 0
    assert lay.pad_s < lay.minor * mesh_backend.LANE


# ------------------------------------------------------------ mesh functions

def test_make_mesh_checks_equal_jax():
    from chunky_bits_tpu.parallel import make_mesh as jmake_mesh

    jdev = _jax_devices()
    for args in ((8, 4, 2), (8, None, 2), (8, 8, None), (None, None, None),
                 (4, None, None)):
        ours = mesh.make_mesh(*args, devices=CPU8)
        theirs = jmake_mesh(*args, devices=jdev)
        assert ours.shape == dict(theirs.shape), args
    for args, match in (((16, 4, 4), "only 8 visible"),
                        ((8, 3, 2), r"dp\(3\) \* sp\(2\) != devices\(8\)")):
        with pytest.raises(ValueError, match=match):
            mesh.make_mesh(*args, devices=CPU8)
        with pytest.raises(ValueError, match=match):
            jmake_mesh(*args, devices=jdev)
    stripe = mesh.make_stripe_mesh(8, dp=2, tp=4, devices=CPU8)
    assert stripe.shape == {"dp": 2, "tp": 4}
    assert stripe.devices[1, 3] is CPU8[7]


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_apply_equals_jax(dp, sp):
    from chunky_bits_tpu.parallel import make_mesh as jmake_mesh
    from chunky_bits_tpu.parallel import sharded_apply as jsharded_apply

    d, p = 10, 4
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(dp * 2, d, 128 * sp, dp * 10 + sp)
    got = mesh.sharded_apply(mesh.make_mesh(8, dp=dp, sp=sp, devices=CPU8),
                             enc[d:], data)
    want = ORACLE.apply_matrix(enc[d:], data)
    assert np.array_equal(got, want)
    jmesh = jmake_mesh(8, dp=dp, sp=sp, devices=_jax_devices())
    assert np.array_equal(got, np.asarray(jsharded_apply(jmesh, enc[d:],
                                                         data)))


def test_encode_step_checksum_equals_jax():
    from chunky_bits_tpu.parallel import encode_step_sharded as jstep
    from chunky_bits_tpu.parallel import make_mesh as jmake_mesh

    d, p = 3, 2
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(8, d, 512, 0)
    parity, checksum = mesh.encode_step_sharded(
        mesh.make_mesh(8, dp=4, sp=2, devices=CPU8), enc, data)
    want = ORACLE.apply_matrix(enc[d:], data)
    assert np.array_equal(parity, want)
    assert checksum == int(want.astype(np.uint64).sum() % (1 << 32))
    jparity, jsum = jstep(jmake_mesh(8, dp=4, sp=2, devices=_jax_devices()),
                          enc, data)
    assert np.array_equal(parity, np.asarray(jparity))
    assert checksum == int(jsum)


def test_encode_step_checksum_wraps(monkeypatch):
    """Parity bytes summing past 2^32 wrap as the JAX uint32 psum does;
    the per-device sums are int64, masked once (the apply is stubbed to
    all-0xFF output so the test stays small)."""
    monkeypatch.setattr(
        gf_kernel, "apply_selected",
        lambda table, x, packed: torch.full(
            (x.shape[0], table.shape[0], x.shape[2]), 0xFF,
            dtype=torch.uint8))
    enc = np.ones((9, 1), dtype=np.uint8)  # d=1, 8 parity rows
    data = np.zeros((8, 1, (1 << 19) + 5), dtype=np.uint8)
    parity, checksum = mesh.encode_step_sharded(
        mesh.make_mesh(8, dp=4, sp=2, devices=CPU8), enc, data)
    total = 255 * parity.size
    assert total > 1 << 32
    assert checksum == total % (1 << 32)


def test_sharded_decode():
    d, p = 10, 4
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(8, d, 256, 1)
    full = np.concatenate([data, ORACLE.apply_matrix(enc[d:], data)], axis=1)
    present = list(range(1, 11))
    dec = jmatrix.decode_matrix(enc, present, [0])
    got = mesh.sharded_apply(mesh.make_mesh(8, dp=8, sp=1, devices=CPU8),
                             dec, full[:, present])
    assert np.array_equal(got[:, 0], data[:, 0])


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8), (8, 1)])
def test_wide_stripe_encode_equals_jax(dp, tp):
    from chunky_bits_tpu.parallel import encode_wide_sharded as jwide
    from chunky_bits_tpu.parallel import make_stripe_mesh as jstripe

    d, p = 16, 6
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(max(dp, 2), d, 384, dp * 100 + tp)
    got = mesh.encode_wide_sharded(
        mesh.make_stripe_mesh(8, dp=dp, tp=tp, devices=CPU8), enc, data)
    assert np.array_equal(got, ORACLE.apply_matrix(enc[d:], data))
    jm = jstripe(8, dp=dp, tp=tp, devices=_jax_devices())
    assert np.array_equal(got, np.asarray(jwide(jm, enc, data)))


def test_wide_stripe_d20_p6_encode_and_decode():
    """BASELINE.md config 5's geometry: parity, then 4 data shards rebuilt
    from 20 survivors, against the JAX function and numpy."""
    from chunky_bits_tpu.parallel import make_stripe_mesh as jstripe
    from chunky_bits_tpu.parallel import wide_apply_sharded as jwide_apply

    d, p = 20, 6
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(4, d, 256, 5)
    stripe = mesh.make_stripe_mesh(8, dp=2, tp=4, devices=CPU8)
    parity = mesh.encode_wide_sharded(stripe, enc, data)
    assert np.array_equal(parity, ORACLE.apply_matrix(enc[d:], data))
    full = np.concatenate([data, parity], axis=1)
    erased = [0, 5, 11, 19]
    present = [i for i in range(d + p) if i not in erased][:d]
    dec = jmatrix.decode_matrix(enc, present, erased)
    got = mesh.wide_apply_sharded(stripe, dec, full[:, present])
    assert np.array_equal(got, data[:, erased])
    jm = jstripe(8, dp=2, tp=4, devices=_jax_devices())
    assert np.array_equal(got, np.asarray(jwide_apply(jm, dec,
                                                      full[:, present])))


def test_wide_stripe_rejects_indivisible_and_leaves_inputs():
    d, p = 10, 4
    enc = jmatrix.build_encode_matrix(d, p)
    stripe = mesh.make_stripe_mesh(8, dp=2, tp=4, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        mesh.wide_apply_sharded(stripe, enc[d:], np.zeros((2, d, 128),
                                                          dtype=np.uint8))
    # the caller's array is read, never written (from_numpy aliases it)
    data = _data(3, 20, 100, 9)
    keep = data.copy()
    mesh.wide_apply_sharded(stripe, jmatrix.build_encode_matrix(20, 6)[20:],
                            data)
    assert np.array_equal(data, keep)


# ------------------------------------------------------- K2's plain version

def test_accumulate_plain_equals_acc_m2_bitmajor():
    """int16 [B, 8R, S] in bit-major row order, element for element with
    the Pallas kernel in interpret mode, and the half-stripe sum identity
    (the tp reduction minus the mesh)."""
    import jax.numpy as jnp

    from chunky_bits_tpu.ops.pallas_kernels import (acc_m2_bitmajor,
                                                    bitmajor_device_matrix,
                                                    pack_acc_bitmajor)

    d, p = 20, 6
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(2, d, 256, 13)
    x = torch.from_numpy(data)
    got = gf_kernel.accumulate(gf_kernel.to_device_matrix(enc[d:], "cpu"), x)
    want = np.asarray(acc_m2_bitmajor(bitmajor_device_matrix(enc[d:]),
                                      jnp.asarray(data), interpret=True))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    assert np.array_equal(got.numpy(), want)
    parity = ORACLE.apply_matrix(enc[d:], data)
    assert np.array_equal(gf_kernel.pack_acc(got).numpy(), parity)
    assert np.array_equal(np.asarray(pack_acc_bitmajor(jnp.asarray(want))),
                          parity)
    half = d // 2
    parts = [gf_kernel.accumulate(
        gf_kernel.to_device_matrix(np.ascontiguousarray(enc[d:, cols]),
                                   "cpu"), x[:, cols])
        for cols in (slice(0, half), slice(half, d))]
    total = parts[0] + parts[1]
    assert total.dtype == torch.int16
    assert torch.equal(total, got)
    assert np.array_equal(gf_kernel.pack_acc(total).numpy(), parity)


@pytest.mark.parametrize("d,p", [(20, 6), (5, 6), (1, 3), (33, 1)])
def test_acc_weight_equals_bit_matrix_bitmajor(d, p):
    """K2's weight (the kernel's A fragments hold it) is the JAX package's
    bit-major bit-matrix with its columns ``bit*K + k`` reordered to
    ``k*8 + bit``."""
    from chunky_bits_tpu.ops.pallas_kernels import bit_matrix_bitmajor

    mat = np.random.default_rng(d * 10 + p).integers(0, 256, (p, d),
                                                     dtype=np.uint8)
    got = gf_kernel.acc_weight(gf_kernel.to_device_matrix(mat, "cpu"))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (8 * p, 8 * d)
    cols = [bit * d + k for k in range(d) for bit in range(8)]
    assert np.array_equal(got.numpy(), bit_matrix_bitmajor(mat)[:, cols])


@pytest.mark.parametrize("d,p,b", [(20, 6, 2), (5, 6, 1), (5, 1, 3)])
def test_acc_weight_product_equals_acc_m2_bitmajor(d, p, b):
    """The product the kernel computes on the tensor cores, ``M2 @ bits``
    with bit j of input row k at row ``k*8 + j``, taken in int32 with
    numpy, equals the Pallas kernel in interpret mode element for
    element."""
    import jax.numpy as jnp

    from chunky_bits_tpu.ops.pallas_kernels import (acc_m2_bitmajor,
                                                    bitmajor_device_matrix)

    mat = jmatrix.build_encode_matrix(20, 6)[20:20 + p, :d]
    data = _data(b, d, 256, 17 + d)
    m2 = gf_kernel.acc_weight(gf_kernel.to_device_matrix(mat, "cpu"))
    bits = np.unpackbits(data[..., None], axis=-1, bitorder="little")
    bits = bits.transpose(0, 1, 3, 2).reshape(b, 8 * d, 256)
    got = m2.numpy().astype(np.int32) @ bits.astype(np.int32)
    want = np.asarray(acc_m2_bitmajor(bitmajor_device_matrix(mat),
                                      jnp.asarray(data), interpret=True))
    assert np.array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("d,p,b,s", [(20, 6, 1, 1), (5, 6, 3, 777),
                                     (3, 2, 2, 97)])
def test_accumulate_plain_equals_bitplane_acc_at_odd_s(d, p, b, s):
    """``bitplane_acc`` takes any S; its rows are ``i*8 + bit``, so it is
    reordered to bit-major before the comparison."""
    import jax.numpy as jnp

    from chunky_bits_tpu.ops import gf256 as jgf256
    from chunky_bits_tpu.ops.bitplane import bitplane_acc

    mat = jmatrix.build_encode_matrix(d, p)[d:]
    data = _data(b, d, s, d + s)
    m2 = jnp.asarray(jgf256.expand_to_bit_matrix(mat), dtype=jnp.bfloat16)
    std = np.asarray(bitplane_acc(m2, jnp.asarray(data)))
    want = std.reshape(b, p, 8, s).transpose(0, 2, 1, 3).reshape(b, 8 * p, s)
    got = gf_kernel.accumulate(gf_kernel.to_device_matrix(mat, "cpu"),
                               torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want.astype(np.int16))


def test_accumulate_on_the_cpu_counts_no_launch_and_checks_shapes():
    before = gf_kernel.ACC_LAUNCHES
    table = gf_kernel.to_device_matrix(np.ones((2, 3), np.uint8), "cpu")
    out = gf_kernel.accumulate(table, torch.zeros((0, 3, 5), dtype=torch.uint8))
    assert tuple(out.shape) == (0, 16, 5)
    assert gf_kernel.ACC_LAUNCHES == before
    with pytest.raises(ErasureError):
        gf_kernel.accumulate(table, torch.zeros((1, 4, 5), dtype=torch.uint8))
    with pytest.raises(ErasureError):
        gf_kernel.pack_acc(torch.zeros((1, 12, 5), dtype=torch.int16))


# ------------------------------------------------ the tp reduce-and-pack

def _partials(tp, b, r, s, seed):
    """tp int16 bit-major partials [b, 8r, s], counts up to 8 * 255."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 8 * 255 // tp + 1, (b, 8 * r, s), dtype=np.int16)
            for _ in range(tp)]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("b", [1, 3])
def test_reduce_pack_plain_equals_jax_psum_and_pack(tp, b):
    """The plain version of the reduce-and-pack, and the wrapper on CPU
    tensors, equal the JAX package's tp step after the accumulator: a sum
    of the partials (what ``psum`` over 'tp' computes) and
    ``pack_acc_bitmajor``.  Odd S; tolerance 0."""
    import jax.numpy as jnp

    from chunky_bits_tpu.ops.pallas_kernels import pack_acc_bitmajor

    host = _partials(tp, b, 6, 97, 100 * tp + b)
    parts = [torch.from_numpy(h) for h in host]
    want = np.asarray(pack_acc_bitmajor(
        jnp.sum(jnp.stack([jnp.asarray(h) for h in host]), axis=0)))
    assert want.dtype == np.uint8 and want.shape == (b, 6, 97)
    got = gf_kernel.reduce_pack_plain(parts)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(gf_kernel.reduce_pack(parts).numpy(), want)


def test_reduce_pack_of_rank_partials_equals_the_transform():
    """K2's partials of the tp ranks of config 5's stripe, reduced and
    packed, give numpy's parity; the partials are left as they were."""
    d, p, tp = 20, 6, 4
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(2, d, 129, 21)
    kb = d // tp
    parts = [gf_kernel.accumulate(
        gf_kernel.to_device_matrix(np.ascontiguousarray(
            enc[d:, t * kb:(t + 1) * kb]), "cpu"),
        torch.from_numpy(np.ascontiguousarray(data[:, t * kb:(t + 1) * kb])))
        for t in range(tp)]
    keep = [q.clone() for q in parts]
    got = gf_kernel.reduce_pack(parts)
    assert np.array_equal(got.numpy(), ORACLE.apply_matrix(enc[d:], data))
    assert all(torch.equal(q, k) for q, k in zip(parts, keep))


def test_reduce_pack_on_the_cpu_counts_no_launch_and_checks_partials():
    before = gf_kernel.REDUCE_PACK_LAUNCHES
    one = torch.zeros((2, 16, 5), dtype=torch.int16)
    assert tuple(gf_kernel.reduce_pack([one, one]).shape) == (2, 2, 5)
    empty = torch.zeros((0, 16, 5), dtype=torch.int16)
    assert tuple(gf_kernel.reduce_pack([empty]).shape) == (0, 2, 5)
    assert gf_kernel.REDUCE_PACK_LAUNCHES == before
    bad = [[], [one] * 9, [one, torch.zeros((2, 16, 6), dtype=torch.int16)],
           [one.to(torch.int32)], [torch.zeros((2, 12, 5), dtype=torch.int16)]]
    for partials in bad:
        with pytest.raises(ErasureError):
            gf_kernel.reduce_pack(partials)


def test_wide_stripe_reduces_through_reduce_pack(monkeypatch):
    """``issue_wide`` reduces and packs each dp group's partials with one
    ``reduce_pack`` call of tp partials, and the result stays equal to the
    JAX function on its virtual mesh."""
    from chunky_bits_tpu.parallel import make_stripe_mesh as jstripe
    from chunky_bits_tpu.parallel import wide_apply_sharded as jwide_apply

    calls = []
    real = gf_kernel.reduce_pack

    def counting(partials):
        calls.append(len(partials))
        return real(partials)

    monkeypatch.setattr(gf_kernel, "reduce_pack", counting)
    d, p = 20, 6
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(4, d, 256, 23)
    got = mesh.wide_apply_sharded(
        mesh.make_stripe_mesh(8, dp=2, tp=4, devices=CPU8), enc[d:], data)
    assert calls == [4, 4]
    jm = jstripe(8, dp=2, tp=4, devices=_jax_devices())
    assert np.array_equal(got, np.asarray(jwide_apply(jm, enc[d:], data)))
    assert np.array_equal(got, ORACLE.apply_matrix(enc[d:], data))


# --------------------------------------------------------------- backends

@pytest.fixture(scope="module")
def mesh_be():
    return mesh_backend.MeshBackend(devices=CPU8)


@pytest.mark.parametrize("d,p,b,s", [
    (10, 4, 16, 4096),   # batch-parallel pure 'dp'
    (10, 4, 3, 1000),    # odd batch and byte length ('sp' pad)
    (10, 4, 2, 1),       # 1-byte shards
    (20, 6, 2, 256),     # wide stripe ('dp','tp'): K2 and the reduction
    (4, 2, 5, 777),      # narrow stripe, odd everything
])
def test_mesh_identity_across_geometries(mesh_be, d, p, b, s):
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(b, d, s, d * s + b)
    got = mesh_be.apply_matrix(enc[d:], data)
    assert got.dtype == np.uint8 and got.shape == (b, p, s)
    assert np.array_equal(got, ORACLE.apply_matrix(enc[d:], data))


def test_mesh_decode_with_erasures(mesh_be):
    d, p = 10, 4
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(4, d, 512, 2)
    parity = ORACLE.apply_matrix(enc[d:], data)
    present = [0, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    dec = jmatrix.decode_matrix(enc, present, [1])
    picked = np.concatenate([data[:, :1], data[:, 2:], parity[:, :1]],
                            axis=1)
    assert np.array_equal(mesh_be.apply_matrix(dec, picked)[:, 0],
                          data[:, 1])


def test_mesh_encode_hash_identity(mesh_be):
    from chunky_bits_tpu.ops.backend import ErasureCoder as JaxCoder

    d, p = 10, 4
    data = _data(6, d, 1024, 3)
    parity, digests = ErasureCoder(d, p, mesh_be).encode_hash_batch(data)
    want, wdig = JaxCoder(d, p, NumpyBackend()).encode_hash_batch(data)
    assert np.array_equal(parity, want)
    assert np.array_equal(digests, wdig)


@pytest.mark.parametrize("d,p,s", [(10, 4, 512), (20, 6, 256)])
def test_mesh_feed_ahead_counters_prove_overlap(d, p, s):
    """encode_hash_batches stages every batch before collecting any: the
    window's own counters show two dispatches in flight."""
    from chunky_bits_tpu.ops.backend import ErasureCoder as JaxCoder

    be = mesh_backend.MeshBackend(depth=2, devices=CPU8)
    data = _data(4, d, s, 4)
    outs = ErasureCoder(d, p, be).encode_hash_batches([data[:2], data[2:]])
    want, wdig = JaxCoder(d, p, NumpyBackend()).encode_hash_batch(data)
    assert np.array_equal(np.concatenate([o[0] for o in outs]), want)
    assert np.array_equal(np.concatenate([o[1] for o in outs]), wdig)
    st = be.pipeline.stats()
    assert st.completed == st.submitted >= 2
    assert st.max_inflight >= 2
    assert st.submits_while_busy >= 1
    assert st.cancelled == 0


def test_mesh_depth_zero_still_identical():
    be = mesh_backend.MeshBackend(depth=0, devices=CPU8)
    d, p = 10, 4
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(4, d, 640, 5)
    assert np.array_equal(be.apply_matrix(enc[d:], data),
                          ORACLE.apply_matrix(enc[d:], data))
    st = be.pipeline.stats()
    assert st.max_inflight <= 1 and st.submits_while_busy == 0


@pytest.mark.parametrize("spec", ["mesh", "tp4"])
@pytest.mark.parametrize("b,s,p", [(0, 16, 6), (2, 0, 6), (0, 0, 0),
                                   (2, 0, 0)])
def test_mesh_ingest_of_empty_batches_equals_jax(spec, b, s, p):
    """No parts, empty shards or no parity: both routes of both mesh
    backends give the JAX coder's (empty or hashlib-of-nothing) output."""
    from chunky_bits_tpu.ops.backend import ErasureCoder as JaxCoder

    be = (mesh_backend.MeshBackend(devices=CPU8) if spec == "mesh"
          else parallel_backend.MeshCudaBackend(spec, devices=CPU8))
    data = np.zeros((b, 20, s), dtype=np.uint8)
    want = JaxCoder(20, p, NumpyBackend()).encode_hash_batch(data)
    coder = ErasureCoder(20, p, be)
    for got in [coder.encode_hash_batch(data)] + coder.encode_hash_batches(
            [data, data]):
        assert all(np.array_equal(x, y) for x, y in zip(got, want))


def test_mesh_failure_raises_with_no_cpu_recompute(monkeypatch):
    """Where the JAX backend degrades to the CPU, the port raises: a
    failed materialization reaches the caller as ErasureError, and the
    younger dispatches of the window are cancelled, not recomputed."""
    be = mesh_backend.MeshBackend(depth=4, devices=CPU8)

    def dead_device(self):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(mesh.MeshDispatch, "materialize", dead_device)
    d, p = 10, 4
    data = _data(4, d, 512, 6)
    with pytest.raises(ErasureError, match="illegal memory access"):
        ErasureCoder(d, p, be).encode_hash_batch(data)
    young = be.submit_apply(jmatrix.build_encode_matrix(d, p)[d:], data)
    be.pipeline.cancel()
    with pytest.raises(ErasureError, match="cancelled"):
        young.result()


def test_mesh_plan_walks_whole_dp_groups_under_the_budget(monkeypatch):
    be = mesh_backend.MeshBackend(devices=CPU8)
    monkeypatch.setattr(be, "max_block_bytes", 3 * 50_000)
    lay, block = be.plan(2, 6, 20, 1000)  # wide: 20000 + 6000 + 4*96000
    assert lay.wide and block == 2        # under budget: one dp group
    lay, block = be.plan(16, 4, 10, 1000)  # 14000 a part, 50000 a block
    assert (lay.dp, block) == (8, 8)
    d, p = 10, 4
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(20, d, 1000, 7)
    assert np.array_equal(be.apply_matrix(enc[d:], data),
                          ORACLE.apply_matrix(enc[d:], data))
    assert be.pipeline.stats().submitted == 3  # blocks of 8, 8 and 4


def test_parse_mesh_spec_equals_jax():
    for spec in ("dp4,sp2", "tp4", "dp=2, sp=4", "dp2,tp4", "sp8"):
        assert parallel_backend.parse_mesh_spec(spec) == \
            jparallel_backend.parse_mesh_spec(spec)
    for bad in ("", "xp3", "dp4,tp2,sp2", "tp2,sp2", "dp4,dp2", "dp0"):
        with pytest.raises(ErasureError):
            parallel_backend.parse_mesh_spec(bad)


def test_explicit_backend_dp_sp_identity():
    be = parallel_backend.MeshCudaBackend("dp4,sp2", devices=CPU8)
    assert be.name == "cuda:dp4,sp2"
    d, p = 5, 3
    enc = jmatrix.build_encode_matrix(d, p)
    for b, s in ((8, 512), (3, 512), (5, 300), (1, 77)):
        data = _data(b, d, s, b * s)
        assert np.array_equal(be.apply_matrix(enc[d:], data),
                              ORACLE.apply_matrix(enc[d:], data)), (b, s)


def test_explicit_backend_wide_stripe_identity():
    be = parallel_backend.MeshCudaBackend("tp4", devices=CPU8)
    assert be.name == "cuda:dp2,tp4"
    d, p = 20, 6
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(3, d, 384, 1)
    want = ORACLE.apply_matrix(enc[d:], data)
    assert np.array_equal(be.apply_matrix(enc[d:], data), want)
    coder = ErasureCoder(d, p, be)
    full = np.concatenate([data, want], axis=1)
    shards = [None if i in (0, 5, 9, 21, 23, 25) else full[0, i]
              for i in range(d + p)]
    out = coder.reconstruct(shards)
    for i in range(d + p):
        assert np.array_equal(out[i], full[0, i])
    parity, digests = coder.encode_hash_batch(data)  # the async route
    assert np.array_equal(parity, want)
    assert np.array_equal(digests, ErasureCoder(
        d, p, backend.NumpyBackend()).encode_hash_batch(data)[1])
    with pytest.raises(ErasureError, match="not divisible by tp=4"):
        be.apply_matrix(enc[d:][:, :18], data[:, :18])


def test_explicit_backend_name_normalization():
    a = parallel_backend.MeshCudaBackend("dp=4, sp=2", devices=CPU8)
    assert a.name == "cuda:dp4,sp2"
    assert parallel_backend.MeshCudaBackend("sp2", devices=CPU8).name == \
        "cuda:dp4,sp2"
    with pytest.raises(ErasureError, match="devices"):
        backend._build_mesh("cuda:dp64,sp2", lambda: (
            parallel_backend.MeshCudaBackend("dp64,sp2", devices=CPU8)))


def test_no_card_raises_for_mesh_names(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv(tunables.VIRTUAL_DEVICES_ENV, "8")
    for name in ("mesh", "cuda:tp4", "cuda:dp2,tp4"):
        with pytest.raises(ErasureError, match="CUDA"):
            backend.get_backend(name)
    with pytest.raises(ErasureError, match="CUDA"):
        virtualmesh.visible_devices()
    with pytest.raises(ErasureError, match="CUDA"):
        virtualmesh.virtual_devices(8, "cuda:0")


def test_virtual_devices_and_env(monkeypatch):
    devs = virtualmesh.virtual_devices(3, "cpu")
    assert [d.index for d in devs] == [0, 1, 2]
    assert all(d.device.type == "cpu" and d.stream is None for d in devs)
    with pytest.raises(ErasureError):
        virtualmesh.virtual_devices(0, "cpu")
    for raw, want in (("8", 8), ("", 0), ("x", 0), ("-2", 0), ("0", 0)):
        monkeypatch.setenv(tunables.VIRTUAL_DEVICES_ENV, raw)
        assert tunables.virtual_devices() == want


def test_batcher_feed_ahead_route_through_a_mesh_backend():
    be = mesh_backend.MeshBackend(devices=CPU8)
    be.name = "mesh-cpu-test"
    backend.register_backend(be)
    d, p = 20, 6
    data = _data(6, d, 256, 8)

    async def drive():
        batcher = EncodeHashBatcher(backend=be.name)
        outs = await asyncio.gather(*(batcher.encode_hash(d, p,
                                                          data[2 * i:2 * i + 2])
                                      for i in range(3)))
        await batcher.aclose()
        return batcher, outs

    try:
        batcher, outs = bounded(lambda: asyncio.run(drive()))
    finally:
        with backend._REGISTRY_LOCK:
            backend._REGISTRY.pop(be.name, None)
        with backend._CODER_LOCK:
            for key in [k for k in backend._CODER_CACHE if k[2] == be.name]:
                del backend._CODER_CACHE[key]
    want = ErasureCoder(d, p, backend.NumpyBackend()).encode_hash_batch(data)
    assert np.array_equal(np.concatenate([o[0] for o in outs]), want[0])
    assert np.array_equal(np.concatenate([o[1] for o in outs]), want[1])
    assert batcher.dispatches == 3 and batcher.groups == 1
    assert be.pipeline.stats().submits_while_busy >= 1


def test_object_round_trip_d20_p6_across_packages(tmp_path):
    """Written by the port through a CPU mesh backend (``tp`` layout for a
    small batch) over 26 temp dirs and read by the JAX package, and the
    other way round; the file references are equal."""
    from chunky_bits_tpu_torch.file import (FileReadBuilder, FileReference,
                                            FileWriteBuilder,
                                            LocationsDestination)
    from chunky_bits_tpu_torch.utils import aio
    from tests.golden import generate as gen

    be = parallel_backend.MeshCudaBackend("dp2,tp4", devices=CPU8)
    be.name = "cuda-cpu-test:dp2,tp4"
    backend.register_backend(be)
    d, p, chunk = 20, 6, 1 << 12
    data = gen.payload(3 * d * chunk + 999, 11)
    dirs = {}
    for side in ("port", "jax"):
        dirs[side] = []
        for i in range(d + p):
            path = tmp_path / side / f"d{i}"
            path.mkdir(parents=True)
            dirs[side].append(str(path))

    async def main():
        ours = await (FileWriteBuilder().with_backend(be.name)
                      .with_destination(LocationsDestination(dirs["port"]))
                      .with_chunk_size(chunk).with_data_chunks(d)
                      .with_parity_chunks(p).write(aio.BytesReader(data)))
        theirs = await (jfile.FileWriteBuilder().with_backend("numpy")
                        .with_destination(
                            jfile.LocationsDestination(dirs["jax"]))
                        .with_chunk_size(chunk).with_data_chunks(d)
                        .with_parity_chunks(p)
                        .write(jaio.BytesReader(data)))
        obj = ours.to_obj()
        assert str(obj).replace(str(tmp_path / "port"),
                                str(tmp_path / "jax")) == str(theirs.to_obj())
        jref = jfile.FileReference.from_obj(obj)
        assert await jref.read_builder().with_backend("numpy").read_all() \
            == data
        pref = FileReference.from_obj(theirs.to_obj())
        assert await (FileReadBuilder(pref).with_backend(be.name)
                      .read_all()) == data

    try:
        bounded(lambda: asyncio.run(main()))
    finally:
        with backend._REGISTRY_LOCK:
            backend._REGISTRY.pop(be.name, None)
        with backend._CODER_LOCK:
            for key in [k for k in backend._CODER_CACHE if k[2] == be.name]:
                del backend._CODER_CACHE[key]
    assert be.pipeline.stats().completed >= 1


@pytest.mark.cuda
def test_accumulator_kernel_on_the_card():
    """On a CUDA tensor the wrapper launches K2 (one count) and gives the
    plain version's int16 counts; the mesh backend on 8 logical devices
    of the card gives numpy's parity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    d, p = 20, 6
    enc = jmatrix.build_encode_matrix(d, p)
    data = _data(3, d, 4097, 12)
    table = gf_kernel.to_device_matrix(enc[d:], "cuda")
    x = torch.from_numpy(data).cuda()
    before = gf_kernel.ACC_LAUNCHES
    got = gf_kernel.accumulate(table, x)
    assert gf_kernel.ACC_LAUNCHES == before + 1
    assert torch.equal(got, gf_kernel.accumulate_plain(table, x))
    be = mesh_backend.MeshBackend(
        devices=virtualmesh.virtual_devices(8, "cuda:0"))
    assert np.array_equal(be.apply_matrix(enc[d:], data[:2]),
                          ORACLE.apply_matrix(enc[d:], data[:2]))


@pytest.mark.cuda
def test_mesh_backends_over_every_visible_gpu(monkeypatch):
    """With several cards, one logical device per card: every layout of
    ``mesh`` and the explicit specs give numpy's bytes, the tp partials
    crossing cards by ``.to()``."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    monkeypatch.delenv(tunables.VIRTUAL_DEVICES_ENV, raising=False)
    devices = virtualmesh.visible_devices()
    n = len(devices)
    assert n == torch.cuda.device_count()
    assert len({ld.device for ld in devices}) == n
    d, p = 20, 6
    enc = jmatrix.build_encode_matrix(d, p)
    be = mesh_backend.MeshBackend(devices=devices)
    for b, s in ((1, 4096), (2, 4097), (n, 1000), (2 * n + 1, 777)):
        data = _data(b, d, s, b + s)
        lay = mesh_backend.plan_layout(n, b, d, s)
        assert np.array_equal(be.apply_matrix(enc[d:], data),
                              ORACLE.apply_matrix(enc[d:], data)), lay
    specs = [f"dp{n}", f"sp{n}"] + [f"dp{n // t},tp{t}"
                                    for t in range(2, n + 1)
                                    if n % t == 0 and d % t == 0]
    data = _data(3, d, 4096, 3)
    for spec in specs:
        ex = parallel_backend.MeshCudaBackend(spec, devices=devices)
        assert np.array_equal(ex.apply_matrix(enc[d:], data),
                              ORACLE.apply_matrix(enc[d:], data)), spec


@pytest.mark.cuda
def test_reduce_pack_kernel_on_the_card():
    """On CUDA tensors the wrapper launches the reduce-and-pack (one count
    a call) and gives its plain version's bytes at tp 1 to 8, odd S and
    unaligned partials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for tp in (1, 2, 4, 8):
        for b, r, s in ((1, 6, 97), (3, 4, 4096)):
            parts = [torch.from_numpy(h).cuda()
                     for h in _partials(tp, b, r, s, tp + s)]
            before = gf_kernel.REDUCE_PACK_LAUNCHES
            got = gf_kernel.reduce_pack(parts)
            assert gf_kernel.REDUCE_PACK_LAUNCHES == before + 1
            assert torch.equal(got, gf_kernel.reduce_pack_plain(parts))
        flat = [torch.from_numpy(h.reshape(-1)).cuda()
                for h in _partials(tp, 1, 2, 4097, tp)]
        parts = [f[1:1 + 16 * 256].view(1, 16, 256) for f in flat]
        assert torch.equal(gf_kernel.reduce_pack(parts),
                           gf_kernel.reduce_pack_plain(parts))
