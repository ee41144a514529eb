"""The port's per-row SHA-256 against hashlib and the JAX package's device
SHA (``sha256_rows_device``, run on the CPU as its own tests run it).

Exact byte equality at the row lengths of tests/test_sha256_jax.py and at
the edges of the CUDA kernel's padding, FIPS padding included.  The
kernel itself runs only on a card (``-m cuda``).
"""

import hashlib

import numpy as np
import pytest
import torch

from chunky_bits_tpu.ops.sha256_jax import _pad_tail, sha256_rows_device
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import sha256

SHAPES = [(1, 0), (1, 1), (2, 55), (3, 56), (2, 64), (4, 100), (2, 192),
          (3, 1000),
          # the edges of the kernel's padding and its producer warps: one
          # byte short of and past a block, a tail that takes two blocks,
          # and a row of many blocks with a ragged tail
          (2, 63), (2, 65), (2, 119), (2, 120), (1, 4096 + 777)]


def _hashlib_rows(rows: np.ndarray) -> np.ndarray:
    return np.stack([
        np.frombuffer(hashlib.sha256(r.tobytes()).digest(), dtype=np.uint8)
        for r in rows])


@pytest.mark.parametrize("n,s", SHAPES)
def test_plain_equals_hashlib_and_jax(n, s):
    rows = np.random.default_rng(s).integers(0, 256, (n, s), dtype=np.uint8)
    got = sha256.sha256_rows_plain(torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, _hashlib_rows(rows))
    assert np.array_equal(got, sha256_rows_device(rows))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    rows = np.random.default_rng(3).integers(0, 256, (3, 70), dtype=np.uint8)
    before = sha256.LAUNCHES
    got = sha256.sha256_rows(torch.from_numpy(rows)).numpy()
    assert sha256.LAUNCHES == before
    assert np.array_equal(got, _hashlib_rows(rows))


def test_two_sources_land_data_then_parity():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (3, 10, 130), dtype=np.uint8)
    b = rng.integers(0, 256, (3, 4, 130), dtype=np.uint8)
    got = sha256.sha256_parts(torch.from_numpy(a), torch.from_numpy(b))
    want = _hashlib_rows(np.concatenate([a, b], axis=1).reshape(42, 130))
    assert np.array_equal(got.numpy().reshape(42, 32), want)


@pytest.mark.parametrize("s", [0, 1, 54, 55, 56, 63, 64, 119, 120, 1 << 20])
def test_pad_tail_equals_jax(s):
    assert np.array_equal(sha256.pad_tail(s), _pad_tail(s))
    assert sha256.blocks_per_row(s) == (s + _pad_tail(s).size) // 64


def test_empty_batch():
    out = sha256.sha256_rows(torch.empty((0, 128), dtype=torch.uint8))
    assert tuple(out.shape) == (0, 32)


def test_rejects_bad_rows():
    with pytest.raises(ErasureError):
        sha256.sha256_rows(torch.zeros((2, 3, 4), dtype=torch.uint8))
    with pytest.raises(ErasureError):
        sha256.sha256_rows_plain(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ErasureError):
        sha256.sha256_parts(torch.zeros((2, 3, 4), dtype=torch.uint8),
                            torch.zeros((3, 1, 4), dtype=torch.uint8))


@pytest.mark.cuda
def test_kernel_edges_on_the_card():
    """On a CUDA tensor the wrapper launches the kernel (one count a call)
    and gives hashlib's digests at the padding edges, at 1, 31 and 33 rows
    (a block of 32 lanes either side) and from an unaligned base."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for n in (1, 31, 33):
        for _, s in SHAPES:
            rows = rng.integers(0, 256, (n, s), dtype=np.uint8)
            before = sha256.LAUNCHES
            got = sha256.sha256_rows(torch.from_numpy(rows).cuda())
            assert sha256.LAUNCHES == before + 1
            assert np.array_equal(got.cpu().numpy(), _hashlib_rows(rows))
    flat = rng.integers(0, 256, 33 * 4096 + 1, dtype=np.uint8)
    got = sha256.sha256_rows(torch.from_numpy(flat).cuda()[1:].view(33, 4096))
    assert np.array_equal(got.cpu().numpy(),
                          _hashlib_rows(flat[1:].reshape(33, 4096)))
