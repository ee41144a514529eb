"""Compute plane: GF(2^8) math, the CUDA kernels and the erasure backends."""

from chunky_bits_tpu_torch.ops.backend import (  # noqa: F401
    ErasureBackend,
    ErasureCoder,
    get_backend,
    get_coder,
    register_backend,
)
