"""The plain reference the benchmark holds the program's answers against.

NumPy Reed-Solomon over GF(2^8) and ``hashlib`` SHA-256, written from the
published construction (the Backblaze JavaReedSolomon matrix that the
``reed-solomon-erasure`` crate uses).  Nothing here imports ``jax``, the
JAX package or the PyTorch port: the reference derives every matrix,
parity row and digest again from the inputs the benchmark made.
"""
