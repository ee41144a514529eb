"""chunky-bits on PyTorch and CUDA for an NVIDIA H100.

A port of ``chunky_bits_tpu`` (the JAX/TPU package, kept beside it as the
reference).  Files are split into parts of ``d`` data + ``p`` parity chunks
(Reed-Solomon over GF(2^8), or the pm-msr regenerating code),
content-addressed by SHA-256.  The compute plane is the GF(2^8) transform
and per-shard SHA-256 as CUDA kernels written for Hopper (``csrc/``), the
``ErasureCoder`` that drives them and the batchers, beside the native
host codec (``csrc/gf256.cpp``, host C++ built by g++: the ``native``
backends, the SHA-NI row hasher and the fused read+hash); above it sit the
object codec (``file/``), the cluster (``cluster/``), the HTTP gateway
(``gateway/``) and the ``chunky-bits`` CLI (``cli/``, ``python -m
chunky_bits_tpu_torch``).
Every kernel has a plain PyTorch version beside it, which runs for tensors
on the CPU.

The package imports ``torch``, numpy and the stdlib, never ``jax`` and
nothing of ``chunky_bits_tpu``, and reads only ``CHUNKY_BITS_TORCH_*``
environment variables.
"""

__version__ = "0.1.0"

from chunky_bits_tpu_torch.errors import (  # noqa: F401
    ChunkyBitsError,
    ClusterError,
    ErasureError,
    FileReadError,
    FileWriteError,
    LocationError,
    LocationParseError,
    MetadataReadError,
    ShardError,
)
