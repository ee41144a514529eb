"""The port's per-row SHA-256 against hashlib and the JAX package's device
SHA (``sha256_rows_device``, run on the CPU as its own tests run it).

Exact byte equality at the row lengths of tests/test_sha256_jax.py, FIPS
padding included.
"""

import hashlib

import numpy as np
import pytest
import torch

from chunky_bits_tpu.ops.sha256_jax import _pad_tail, sha256_rows_device
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import sha256

SHAPES = [(1, 0), (1, 1), (2, 55), (3, 56), (2, 64), (4, 100), (2, 192),
          (3, 1000)]


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
