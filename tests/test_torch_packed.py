"""The port's packed GF(2^8) kernel (K3) against the JAX package.

The plain version of the field-multiplexed kernel,
``apply_matrix_packed_plain``, must give the bytes of the JAX
``apply_m2_bitmajor_packed`` (Pallas, in interpret mode), of K1's plain
version and of the numpy oracle at the gate corners and inside the gate,
with random and all-0xFF shards and with decode rows.  The gate, the env flag and the backends' kernel choice are
held against the JAX package too.  Tolerance 0: integer arithmetic.
"""

import numpy as np
import pytest
import torch

from chunky_bits_tpu.cluster.tunables import env_flag as jax_env_flag
from chunky_bits_tpu.ops import matrix as jmatrix
from chunky_bits_tpu.ops.backend import NumpyBackend
from chunky_bits_tpu.ops.pallas_kernels import (apply_m2_bitmajor_packed,
                                                bitmajor_device_matrix)
from chunky_bits_tpu.ops.pallas_kernels import \
    packed_geometry_ok as jax_packed_geometry_ok
from chunky_bits_tpu_torch.cluster import tunables
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import backend, gf_kernel

#: (d, p, batch, S): the gate corners and interior geometries of the JAX
#: package's own packed-kernel test, trimmed to keep this file fast
GEOMETRIES = [(10, 4, 2, 512), (3, 2, 3, 256), (15, 8, 1, 256),
              (1, 1, 2, 256), (15, 1, 1, 512), (1, 8, 3, 256),
              (12, 6, 1, 768)]


def _plain(mat, data, packed=True):
    table = gf_kernel.to_device_matrix(mat, "cpu")
    fn = (gf_kernel.apply_matrix_packed_plain if packed
          else gf_kernel.apply_matrix_plain)
    return fn(table, torch.from_numpy(data)).numpy()


def _jax_packed(mat, data):
    import jax.numpy as jnp

    return np.asarray(apply_m2_bitmajor_packed(
        bitmajor_device_matrix(mat), jnp.asarray(data), interpret=True))


@pytest.mark.parametrize("d,p,batch,s", GEOMETRIES)
def test_plain_equals_jax_interpret_k1_and_numpy(d, p, batch, s):
    enc = jmatrix.build_encode_matrix(d, p)[d:]
    data = np.random.default_rng(d * 100 + p).integers(
        0, 256, (batch, d, s), dtype=np.uint8)
    got = _plain(enc, data)
    assert np.array_equal(got, NumpyBackend().apply_matrix(enc, data))
    assert np.array_equal(got, _plain(enc, data, packed=False))
    assert np.array_equal(got, _jax_packed(enc, data))


@pytest.mark.parametrize("d,p", [(15, 8), (1, 1), (1, 8), (15, 1), (10, 4)])
def test_all_ones_shards_fill_both_fields(d, p):
    """0xFF shards set every bit, so each field holds its largest
    popcount (4K at d=15: 60, one step under the 6-bit ceiling)."""
    enc = jmatrix.build_encode_matrix(d, p)[d:]
    data = np.full((2, d, 256), 0xFF, dtype=np.uint8)
    got = _plain(enc, data)
    assert np.array_equal(got, NumpyBackend().apply_matrix(enc, data))
    assert np.array_equal(got, _plain(enc, data, packed=False))


@pytest.mark.parametrize("d,p,fill", [(10, 4, None), (15, 8, 0xFF),
                                      (3, 2, None)])
def test_decode_rows(d, p, fill):
    """Decode matrices have dense rows; the rebuilt rows must equal the
    lost ones and the JAX kernel's output."""
    rng = np.random.default_rng(d + p)
    enc = jmatrix.build_encode_matrix(d, p)
    data = (np.full((2, d, 256), fill, dtype=np.uint8) if fill is not None
            else rng.integers(0, 256, (2, d, 256), dtype=np.uint8))
    full = np.concatenate([data, NumpyBackend().apply_matrix(enc[d:], data)],
                          axis=1)
    lost = [0, 1, d + p - 2, d + p - 1][:p]
    present = [i for i in range(d + p) if i not in lost][:d]
    dec = jmatrix.decode_matrix(enc, present, lost)
    picked = np.ascontiguousarray(full[:, present])
    got = _plain(dec, picked)
    assert np.array_equal(got, full[:, lost])
    assert np.array_equal(got, _jax_packed(dec, picked))


def test_gate_equals_jax():
    for k in range(1, 17):
        for r in range(1, 10):
            for s in (128, 256, 768):
                assert (gf_kernel.packed_geometry_ok(r, k, s)
                        == jax_packed_geometry_ok(r, k, s)), (r, k, s)
    assert gf_kernel.packed_geometry_ok(4, 10, 0) \
        == jax_packed_geometry_ok(4, 10, 0)


@pytest.mark.parametrize("r,k,s", [(9, 10, 512), (4, 16, 512), (4, 10, 128),
                                   (4, 10, 300)])
def test_outside_the_gate_raises(r, k, s):
    mat = np.ones((r, k), dtype=np.uint8)
    table = gf_kernel.to_device_matrix(mat, "cpu")
    x = torch.zeros((1, k, s), dtype=torch.uint8)
    with pytest.raises(ErasureError, match="gate"):
        gf_kernel.apply_matrix_packed(table, x)
    with pytest.raises(ErasureError, match="gate"):
        gf_kernel.apply_matrix_packed_plain(table, x)
    # the selector takes K1 there, as apply_m2_bitmajor does
    assert tuple(gf_kernel.apply_selected(table, x, True).shape) == (1, r, s)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    enc = jmatrix.build_encode_matrix(10, 4)[10:]
    data = np.random.default_rng(3).integers(0, 256, (2, 10, 256),
                                             dtype=np.uint8)
    before = (gf_kernel.LAUNCHES, gf_kernel.PACKED_LAUNCHES)
    got = gf_kernel.apply_matrix_packed(
        gf_kernel.to_device_matrix(enc, "cpu"), torch.from_numpy(data))
    assert (gf_kernel.LAUNCHES, gf_kernel.PACKED_LAUNCHES) == before
    assert np.array_equal(got.numpy(), NumpyBackend().apply_matrix(enc, data))


@pytest.mark.parametrize("raw", [None, "", "0", "1", "true", "TRUE", " yes ",
                                 "no", "Off", "false ", "2", "on"])
def test_env_flag_parses_like_the_jax_package(monkeypatch, raw):
    name = tunables.PACKED_KERNEL_ENV
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    for default in (False, True):
        assert (tunables.env_flag(name, default=default)
                == jax_env_flag(name, default=default))
    assert backend.packed_enabled(None) == jax_env_flag(name)


def test_jax_env_var_does_not_switch_the_port(monkeypatch):
    monkeypatch.delenv(tunables.PACKED_KERNEL_ENV, raising=False)
    monkeypatch.setenv("CHUNKY_BITS_TPU_PACKED_KERNEL", "1")
    assert backend.packed_enabled(None) is False
    monkeypatch.setenv(tunables.PACKED_KERNEL_ENV, "1")
    assert backend.packed_enabled(None) is True
    assert backend.packed_enabled(False) is False


@pytest.mark.parametrize("packed,s,want", [(True, 256, "packed"),
                                           (True, 96, "k1"),
                                           (False, 256, "k1")])
def test_torch_backend_takes_the_kernel_the_gate_picks(monkeypatch, packed,
                                                       s, want):
    """``packed`` on and a gated geometry take the packed plain version,
    anything else K1's, in both ``apply_matrix`` and ``encode_and_hash``;
    the bytes are the same either way."""
    calls = []
    for name in ("apply_matrix_packed_plain", "apply_matrix_plain"):
        real = getattr(gf_kernel, name)
        monkeypatch.setattr(
            gf_kernel, name,
            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    be = backend.TorchBackend(packed=packed)
    coder = backend.ErasureCoder(3, 2, be)
    data = np.random.default_rng(s).integers(0, 256, (2, 3, s),
                                             dtype=np.uint8)
    ref = backend.ErasureCoder(3, 2, backend.NumpyBackend())
    assert np.array_equal(coder.encode_batch(data), ref.encode_batch(data))
    parity, digests = coder.encode_hash_batch(data)
    want_parity, want_digests = ref.encode_hash_batch(data)
    assert np.array_equal(parity, want_parity)
    assert np.array_equal(digests, want_digests)
    name = ("apply_matrix_packed_plain" if want == "packed"
            else "apply_matrix_plain")
    assert calls == [name, name]


@pytest.mark.parametrize("packed", [False, True])
def test_torch_backend_sha_routes_agree(packed):
    """The torch backend's fused ingest (parity from the plain kernel the
    knob selects, digests from hashlib on the host) gives the numpy
    oracle's parity and digests."""
    data = np.random.default_rng(9).integers(0, 256, (2, 10, 256),
                                             dtype=np.uint8)
    coder = backend.ErasureCoder(
        10, 4, backend.TorchBackend(packed=packed))
    want = backend.ErasureCoder(10, 4, backend.NumpyBackend())
    for got, ref in zip(coder.encode_hash_batch(data),
                        want.encode_hash_batch(data)):
        assert np.array_equal(got, ref)


@pytest.mark.cuda
def test_packed_kernel_on_the_card():
    """On a CUDA tensor the wrapper launches the kernel (one count) and
    gives the plain version's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    enc = jmatrix.build_encode_matrix(10, 4)[10:]
    data = np.random.default_rng(4).integers(0, 256, (3, 10, 4096),
                                             dtype=np.uint8)
    table = gf_kernel.to_device_matrix(enc, "cuda")
    x = torch.from_numpy(data).cuda()
    before = gf_kernel.PACKED_LAUNCHES
    got = gf_kernel.apply_matrix_packed(table, x)
    assert gf_kernel.PACKED_LAUNCHES == before + 1
    assert torch.equal(got, gf_kernel.apply_matrix_packed_plain(table, x))
