"""Faults planted under the timed path of a write.  A run takes one only
when asked (``--fault``); the benchmark's own runs never do.  The tests
plant each on the CPU and see ``correct`` come out false, and the control
and ``half`` are run on the chip the same way.

* ``control``: the reference put in the program's place with one stated
  guarantee broken: parity from the Vandermonde rows themselves, not from
  the systematic Reed-Solomon matrix of the configuration.
* ``half``: the second half of each dispatch's batch left out (its
  outputs zero).
* ``alter``: one byte of every answer altered where it is produced (the
  first parity digest of each part written).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional

import numpy as np

from gpubench.reference import rs

FAULTS = ("control", "half", "alter")


def _vandermonde_rows(rows: list[int], d: int) -> np.ndarray:
    return np.array([[rs.power(r, c) for c in range(d)] for r in rows],
                    dtype=np.uint8)


def _encode_control(self, data: np.ndarray):
    b, d, s = data.shape
    mat = _vandermonde_rows(list(range(d, d + self.parity)), d)
    parity = np.stack([rs.apply(mat, data[i]) for i in range(b)]) \
        if b else np.zeros((0, self.parity, s), dtype=np.uint8)
    rows = np.concatenate([data, parity], axis=1)
    digests = np.array([[list(hashlib.sha256(r).digest()) for r in part]
                        for part in rows], dtype=np.uint8)
    return parity, digests.reshape(b, d + self.parity, 32)


def install(fault: Optional[str]) -> Callable[[], None]:
    """Plant ``fault`` under the encode of every write; returns the
    function that takes it out again."""
    if fault is None:
        return lambda: None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder

    real = ErasureCoder.encode_hash_batch

    def planted(self, data):
        if fault == "control":
            return _encode_control(self, data)
        parity, digests = (np.array(x) for x in real(self, data))
        if fault == "half":
            lo = data.shape[0] // 2
            parity[lo:] = 0
            digests[lo:] = 0
        else:
            digests[:, self.data, 0] ^= 1
        return parity, digests

    ErasureCoder.encode_hash_batch = planted
    return lambda: setattr(ErasureCoder, "encode_hash_batch", real)

