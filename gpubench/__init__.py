"""The benchmark of ``chunky_bits_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m gpubench.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The harness is driven by data.  A configuration is ``configs/<name>.json``,
a traffic mix is ``traffic/<name>.json`` (read by the one generator in
``generator.py``, which finds the operation that the mix names as
``traffic/<op>.py``), and every metric is a small reader in
``metrics/<name>.py``.  ``reference/`` holds the plain NumPy and hashlib
reference that decides ``correct``.  Nothing here imports ``jax``,
``jaxlib``, ``flax`` or the JAX package.
"""
