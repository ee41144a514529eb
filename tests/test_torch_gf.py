"""The port's GF(2^8) host math and its GF apply against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; every
comparison is exact byte equality (all arithmetic is integer).  The JAX
side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode, and the numpy oracle.
"""

import numpy as np
import pytest
import torch

from chunky_bits_tpu.ops import gf256 as jgf256
from chunky_bits_tpu.ops import matrix as jmatrix
from chunky_bits_tpu.ops.backend import NumpyBackend
from chunky_bits_tpu.ops.pallas_kernels import apply_matrix_pallas
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256, gf_kernel, matrix

#: parity rows at d=3 p=2, for the wrapper's own checks
PARITY_3_2 = jmatrix.build_encode_matrix(3, 2)[3:]

GRID = [(1, 0), (1, 1), (2, 1), (3, 2), (4, 2), (6, 3), (10, 4), (12, 4),
        (16, 8), (20, 6)]


def test_gf256_tables_equal():
    assert np.array_equal(gf256.EXP_TABLE, jgf256.EXP_TABLE)
    assert np.array_equal(gf256.LOG_TABLE, jgf256.LOG_TABLE)
    assert np.array_equal(gf256.MUL_TABLE, jgf256.MUL_TABLE)
    mat = np.random.default_rng(0).integers(0, 256, (3, 5), dtype=np.uint8)
    assert np.array_equal(gf256.expand_to_bit_matrix(mat),
                          jgf256.expand_to_bit_matrix(mat))


@pytest.mark.parametrize("d,p", GRID)
def test_encode_and_decode_matrices_equal(d, p):
    enc = matrix.build_encode_matrix(d, p)
    assert np.array_equal(enc, jmatrix.build_encode_matrix(d, p))
    rng = np.random.default_rng(d * 100 + p)
    lost = sorted(rng.choice(d + p, size=p, replace=False).tolist())
    present = [i for i in range(d + p) if i not in lost]
    if lost:
        assert np.array_equal(matrix.decode_matrix(enc, present, lost),
                              jmatrix.decode_matrix(enc, present, lost))


def test_expand_table_holds_mul_bit_matrix_columns():
    mat = np.random.default_rng(1).integers(0, 256, (4, 10), dtype=np.uint8)
    table = gf_kernel.expand_table(mat)
    assert table.shape == (4, 10, 8)
    assert np.array_equal(table[..., 0], mat)
    for i, k in ((0, 0), (3, 9), (2, 5)):
        bits = (table[i, k][None, :] >> np.arange(8)[:, None]) & 1
        assert np.array_equal(bits, jgf256.mul_bit_matrix(int(mat[i, k])))
    dev = gf_kernel.to_device_matrix(mat, "cpu")
    assert dev.dtype == torch.uint8 and np.array_equal(dev.numpy(), table)


def _rows(d, p):
    """Encode rows and the 4-erasure decode rows at (d, p), the pattern
    bench.py uses (shards 0, 1, 12, 13 lost at d=10 p=4)."""
    enc = jmatrix.build_encode_matrix(d, p)
    lost = [0, 1, d + p - 2, d + p - 1]
    present = [i for i in range(d + p) if i not in lost][:d]
    return {"encode": enc[d:],
            "decode": jmatrix.decode_matrix(enc, present, lost)}


@pytest.mark.parametrize("which", ["encode", "decode"])
@pytest.mark.parametrize("batch", [2, 3])
def test_plain_equals_pallas_interpret_and_numpy(which, batch):
    mat = _rows(10, 4)[which]
    data = np.random.default_rng(batch).integers(
        0, 256, (batch, 10, 256), dtype=np.uint8)
    got = gf_kernel.apply_matrix_plain(gf_kernel.to_device_matrix(mat, "cpu"),
                                       torch.from_numpy(data)).numpy()
    assert np.array_equal(
        got, np.asarray(apply_matrix_pallas(mat, data, interpret=True)))
    assert np.array_equal(got, NumpyBackend().apply_matrix(mat, data))


@pytest.mark.parametrize("which", ["encode", "decode"])
@pytest.mark.parametrize("s", [1, 17])
def test_plain_ragged_widths_equal_numpy(which, s):
    mat = _rows(10, 4)[which]
    data = np.random.default_rng(s).integers(0, 256, (3, 10, s),
                                             dtype=np.uint8)
    got = gf_kernel.apply_matrix_plain(gf_kernel.to_device_matrix(mat, "cpu"),
                                       torch.from_numpy(data)).numpy()
    assert np.array_equal(got, NumpyBackend().apply_matrix(mat, data))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    mat = PARITY_3_2
    data = np.random.default_rng(7).integers(0, 256, (2, 3, 33),
                                             dtype=np.uint8)
    before = gf_kernel.LAUNCHES
    got = gf_kernel.apply_matrix(gf_kernel.to_device_matrix(mat, "cpu"),
                                 torch.from_numpy(data)).numpy()
    assert gf_kernel.LAUNCHES == before  # the plain version is no launch
    assert np.array_equal(got, NumpyBackend().apply_matrix(mat, data))


@pytest.mark.parametrize("shape", [(0, 3, 16), (2, 3, 0)])
def test_empty_batches_return_empty(shape):
    table = gf_kernel.to_device_matrix(PARITY_3_2, "cpu")
    out = gf_kernel.apply_matrix(table, torch.zeros(shape, dtype=torch.uint8))
    assert tuple(out.shape) == (shape[0], 2, shape[2])


def test_wrapper_rejects_bad_operands():
    table = gf_kernel.to_device_matrix(PARITY_3_2, "cpu")
    with pytest.raises(ErasureError):
        gf_kernel.apply_matrix(table,
                               torch.zeros((2, 4, 8), dtype=torch.uint8))
    with pytest.raises(ErasureError):
        gf_kernel.apply_matrix(table, torch.zeros((2, 3, 8),
                                                  dtype=torch.int16))
    with pytest.raises(ErasureError):
        gf_kernel.apply_matrix(table[..., :4],
                               torch.zeros((2, 3, 8), dtype=torch.uint8))
