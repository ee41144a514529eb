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


# --------------------------------------------- K1's weight and row order
#
# ``csrc/gf_apply.cu`` builds its 0/1 weight on the card from the
# ``[R, K, 8]`` table; these helpers restate its row layout on the CPU, as
# a model for the tests below (the kernel itself is held against the plain
# version by the ``cuda``-marked test and by chip_smoke.py).

#: output byte-rows of one pass of the kernel (one ``gridDim.z``)
_PASS_ROWS = 8


def _row_order(r: int) -> np.ndarray:
    """The kernel's weight rows for R output byte-rows, in its order: for
    each, the bit-major row ``bit*R + i`` of ``bit_matrix_bitmajor`` it
    holds, -1 for a zero (padding) row.  A pass takes 8 byte-rows (4 for
    R <= 4) in 16-row m-tiles; its row ``16*mt + 8*h + g`` is bit
    ``2*(mt%2) + h + 4*(g//4)`` of byte-row ``4*(mt//2) + g%4``."""
    per_pass = 64 if r > 4 else 32  # 4 or 2 m-tiles of 16 rows
    passes = -(-r // _PASS_ROWS)
    order = np.full(passes * per_pass, -1, dtype=np.int64)
    for p in range(passes):
        for row in range(per_pass):
            mt, h, g = row // 16, (row // 8) & 1, row & 7
            i = _PASS_ROWS * p + 4 * (mt // 2) + (g & 3)
            bit = 2 * (mt & 1) + h + 4 * (g >> 2)
            if i < r:
                order[p * per_pass + row] = bit * r + i
    return order


def _apply_weight(table: torch.Tensor) -> np.ndarray:
    """The kernel's 0/1 weight ``[rows, 8K]``: the rows of
    ``acc_weight(table)`` (columns ``k*8 + j``, bit j of input byte-row
    k) in ``_row_order``, zero for padding."""
    order = _row_order(table.shape[0])
    w = gf_kernel.acc_weight(table).numpy()
    out = np.zeros((len(order), w.shape[1]), dtype=np.uint8)
    out[order >= 0] = w[order[order >= 0]]
    return out


@pytest.mark.parametrize("d,p", [(10, 4), (20, 6), (3, 2)])
def test_apply_weight_rows_equal_bit_matrix_bitmajor(d, p):
    """The kernel's weight holds the rows of the JAX package's bit-major
    bit-matrix in its row order (zero rows for padding), its columns
    ``bit*K + k`` reordered to ``k*8 + bit``."""
    from chunky_bits_tpu.ops.pallas_kernels import bit_matrix_bitmajor

    for mat in (jmatrix.build_encode_matrix(d, p)[d:],
                np.random.default_rng(d * 10 + p).integers(
                    0, 256, (p, d), dtype=np.uint8)):
        w = _apply_weight(gf_kernel.to_device_matrix(mat, "cpu"))
        order = _row_order(p)
        assert tuple(w.shape) == (len(order), 8 * d)
        cols = [bit * d + k for k in range(d) for bit in range(8)]
        want = bit_matrix_bitmajor(mat)[:, cols]
        for row, src in enumerate(order):
            if src >= 0:
                assert np.array_equal(w[row], want[src]), row
            else:
                assert not w[row].any(), row


@pytest.mark.parametrize("r", list(range(1, 10)) + [16, 17])
def test_apply_row_order_holds_every_bit_row_once(r):
    """Passes of 8 byte-rows (32 weight rows for R <= 4, else 64 a pass),
    every bit-major row ``bit*R + i`` exactly once."""
    order = _row_order(r)
    per_pass = 32 if r <= 4 else 64
    assert len(order) == per_pass * -(-r // _PASS_ROWS)
    assert sorted(int(o) for o in order if o >= 0) == list(range(8 * r))


@pytest.mark.parametrize("d,p,which", [(10, 4, "encode"), (10, 4, "decode"),
                                       (20, 6, "encode"), (3, 2, "encode"),
                                       (33, 9, "encode")])
def test_row_order_parities_pack_to_the_transform(d, p, which):
    """What the kernel computes, in numpy: popcounts of its weight rows and
    the data's bits (k*8 + j), their parities, each placed at the bit and
    byte-row its row order gives; equal to numpy, the plain version and
    the Pallas kernel in interpret mode."""
    enc = jmatrix.build_encode_matrix(d, p)
    mat = enc[d:]
    if which == "decode":
        lost = [0, 1, d + p - 2, d + p - 1]
        mat = jmatrix.decode_matrix(
            enc, [i for i in range(d + p) if i not in lost][:d], lost)
    data = np.random.default_rng(d + p).integers(0, 256, (2, d, 256),
                                                 dtype=np.uint8)
    table = gf_kernel.to_device_matrix(mat, "cpu")
    w = _apply_weight(table).astype(np.int64)
    bits = np.unpackbits(data[..., None], axis=-1, bitorder="little")
    bits = bits.transpose(0, 1, 3, 2).reshape(2, 8 * d, 256).astype(np.int64)
    counts = np.einsum("ok,bks->bos", w, bits)
    r = mat.shape[0]
    got = np.zeros((2, r, 256), dtype=np.uint8)
    for row, src in enumerate(_row_order(r)):
        if src >= 0:
            bit, i = divmod(int(src), r)
            got[:, i] |= ((counts[:, row] & 1) << bit).astype(np.uint8)
    assert np.array_equal(got, NumpyBackend().apply_matrix(mat, data))
    assert np.array_equal(got, gf_kernel.apply_matrix_plain(
        table, torch.from_numpy(data)).numpy())
    assert np.array_equal(
        got, np.asarray(apply_matrix_pallas(mat, data, interpret=True)))


@pytest.mark.cuda
def test_apply_kernel_edges_on_the_card():
    """On a CUDA tensor the wrapper launches K1 (one count a call) and
    gives the plain version's bytes at its edges: R around its passes, K
    around its k-steps, S around its words and units, an unaligned base;
    K above 255 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(11)
    for r, k, s in ((1, 1, 1), (4, 10, 4097), (5, 16, 129), (8, 17, 777),
                    (9, 32, 128), (16, 33, 15), (6, 255, 300)):
        mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
        data = rng.integers(0, 256, (2, k, s), dtype=np.uint8)
        table = gf_kernel.to_device_matrix(mat, "cuda")
        x = torch.from_numpy(data).cuda()
        before = gf_kernel.LAUNCHES
        got = gf_kernel.apply_matrix(table, x)
        assert gf_kernel.LAUNCHES == before + 1
        assert torch.equal(got, gf_kernel.apply_matrix_plain(table, x))
        assert np.array_equal(got.cpu().numpy(),
                              NumpyBackend().apply_matrix(mat, data))
    flat = torch.from_numpy(rng.integers(0, 256, 3 * 10 * 4096 + 1,
                                         dtype=np.uint8)).cuda()
    table = gf_kernel.to_device_matrix(PARITY_3_2, "cuda")
    x = flat[1:1 + 3 * 3 * 4096].view(3, 3, 4096)
    assert torch.equal(gf_kernel.apply_matrix(table, x),
                       gf_kernel.apply_matrix_plain(table, x))
    with pytest.raises(ErasureError):
        gf_kernel.apply_matrix(
            gf_kernel.to_device_matrix(np.ones((1, 256), np.uint8), "cuda"),
            torch.zeros((1, 256, 16), dtype=torch.uint8, device="cuda"))
