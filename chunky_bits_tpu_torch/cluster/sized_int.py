"""Range-validated config numerics (the port of
``chunky_bits_tpu/cluster/sized_int.py``).

Mirrors the reference's sized_int newtypes (src/cluster/sized_int.rs:139-162):
``chunk_size`` is a log2 exponent in 10..=32 (default 20 => 1 MiB),
``data_chunks`` 1..=256 (default 3), ``parity_chunks`` 0..=256 (default 2).
"""

from __future__ import annotations

from chunky_bits_tpu_torch.errors import SerdeError

CHUNK_SIZE_MIN, CHUNK_SIZE_MAX, CHUNK_SIZE_DEFAULT = 10, 32, 20
DATA_MIN, DATA_MAX, DATA_DEFAULT = 1, 256, 3
PARITY_MIN, PARITY_MAX, PARITY_DEFAULT = 0, 256, 2


def _validate(name: str, value, lo: int, hi: int) -> int:
    try:
        i = int(value)
    except (TypeError, ValueError) as err:
        raise SerdeError(f"{name} must be an integer, got {value!r}") from err
    if not (lo <= i <= hi):
        raise SerdeError(
            f"{name} must be greater than {lo} and less than {hi}"
        )
    return i


def chunk_size(value) -> int:
    """Validated log2 chunk size."""
    return _validate("ChunkSize", value, CHUNK_SIZE_MIN, CHUNK_SIZE_MAX)


def data_chunk_count(value) -> int:
    return _validate("DataChunkCount", value, DATA_MIN, DATA_MAX)


def parity_chunk_count(value) -> int:
    return _validate("ParityChunkCount", value, PARITY_MIN, PARITY_MAX)
