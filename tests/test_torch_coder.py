"""The port's erasure plane as a whole against the JAX package's numpy
coder: ingest, degraded read, the batchers, and the package's rules (no
JAX, no ``chunky_bits_tpu`` import, only ``CHUNKY_BITS_TORCH_*`` env vars,
no CPU stand-in for the card).  Exact byte equality throughout."""

import ast
import asyncio
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chunky_bits_tpu.ops import backend as jbackend
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import backend
from chunky_bits_tpu_torch.ops.batching import (EncodeHashBatcher,
                                                ReconstructBatcher)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "chunky_bits_tpu_torch"
LOST = [0, 1, 12, 13]


def _data(b, d, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, d, s),
                                                dtype=np.uint8)


@pytest.mark.parametrize("name", ["torch", "numpy"])
def test_ingest_then_degraded_read_equal_jax(name):
    data = _data(3, 10, 96, 11)
    coder = backend.get_coder(10, 4, name)
    ref = jbackend.get_coder(10, 4, "numpy")
    parity, digests = coder.encode_hash_batch(data)
    want_parity, want_digests = ref.encode_hash_batch(data)
    assert np.array_equal(parity, want_parity)
    assert np.array_equal(digests, want_digests)
    full = np.concatenate([data, parity], axis=1)
    present = [i for i in range(14) if i not in LOST]
    picked = full[:, present[:10]]
    rebuilt = coder.reconstruct_batch_picked(picked, present, LOST)
    assert np.array_equal(rebuilt, full[:, LOST])
    assert np.array_equal(
        rebuilt, ref.reconstruct_batch_picked(picked, present, LOST))


def test_per_part_api_equals_jax():
    coder = backend.get_coder(3, 2, "torch")
    ref = jbackend.get_coder(3, 2, "numpy")
    rows = list(_data(1, 3, 40, 12)[0])
    parity = coder.encode(rows)
    assert all(np.array_equal(a, b) for a, b in zip(parity, ref.encode(rows)))
    shards = rows + parity
    holes = [None, shards[1], shards[2], None, shards[4]]
    assert all(np.array_equal(a, b)
               for a, b in zip(coder.reconstruct(holes), shards))
    assert coder.reconstruct_data(holes)[3] is None
    with pytest.raises(ErasureError):
        coder.reconstruct([None, None, None, shards[3], shards[4]])


def test_batchers_coalesce_and_stay_identical():
    requests = 8
    data = _data(requests, 10, 64, 13)
    ref = jbackend.get_coder(10, 4, "numpy")
    want_parity, want_digests = ref.encode_hash_batch(data)

    async def drive():
        enc = EncodeHashBatcher(backend="torch")
        rec = ReconstructBatcher(backend="torch")
        outs = await asyncio.gather(*(
            enc.encode_hash(10, 4, data[i:i + 1]) for i in range(requests)))
        arrays = [[None if j in LOST else
                   (data[i, j] if j < 10 else want_parity[i, j - 10])
                   for j in range(14)] for i in range(requests)]
        filled = await asyncio.gather(*(rec.reconstruct(10, 4, a)
                                        for a in arrays))
        await enc.aclose()
        await rec.aclose()
        return enc, rec, outs, filled

    enc, rec, outs, filled = asyncio.run(drive())
    for i, (parity, digests) in enumerate(outs):
        assert np.array_equal(parity, want_parity[i:i + 1])
        assert np.array_equal(digests, want_digests[i:i + 1])
    for i, rows in enumerate(filled):
        for j in LOST:
            want = data[i, j] if j < 10 else want_parity[i, j - 10]
            assert np.array_equal(rows[j], want)
    assert enc.dispatches < requests and rec.dispatches < requests


def test_numpy_encode_batcher_runs_unmerged_and_fails_alone(monkeypatch):
    """numpy does not merge: one group, one dispatch per request, and a
    batch that fails fails only its own waiter."""
    requests = 4
    data = _data(requests, 3, 32, 14)
    data[2, 0, 0] = 0xEE  # the marked batch fails
    ref = jbackend.get_coder(3, 2, "numpy")
    numpy_backend = backend.get_backend("numpy")
    apply = numpy_backend.apply_matrix

    def failing(mat, shards):
        if shards[0, 0, 0] == 0xEE:
            raise ErasureError("marked batch")
        return apply(mat, shards)

    monkeypatch.setattr(numpy_backend, "apply_matrix", failing)

    async def drive():
        enc = EncodeHashBatcher(backend="numpy")
        outs = await asyncio.gather(
            *(enc.encode_hash(3, 2, data[i:i + 1]) for i in range(requests)),
            return_exceptions=True)
        await enc.aclose()
        return enc, outs

    enc, outs = asyncio.run(drive())
    assert (enc.groups, enc.dispatches) == (1, requests)
    assert isinstance(outs[2], ErasureError)
    for i in (0, 1, 3):
        parity, digests = outs[i]
        want_parity, want_digests = ref.encode_hash_batch(data[i:i + 1])
        assert np.array_equal(parity, want_parity)
        assert np.array_equal(digests, want_digests)


def test_codes_and_names():
    # pm-msr is ported; d=10 p=4 is a geometry it cannot run
    with pytest.raises(ErasureError, match="parity >= data-1"):
        backend.get_coder(10, 4, "torch", code="pm-msr")
    with pytest.raises(ErasureError):
        backend.get_coder(10, 4, "torch", code="lrc")
    with pytest.raises(ErasureError):
        backend.get_backend("jax")


def test_no_cuda_raises_instead_of_a_cpu_backend(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("CHUNKY_BITS_TORCH_BACKEND", raising=False)
    # the JAX package's knobs do not reconfigure the port
    monkeypatch.setenv("CHUNKY_BITS_TPU_BACKEND", "numpy")
    with pytest.raises(ErasureError, match="CUDA"):
        backend.get_backend()
    with pytest.raises(ErasureError, match="CUDA"):
        backend.get_backend("cuda")
    with pytest.raises(ErasureError, match="CUDA"):
        backend.get_coder(10, 4)
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    assert backend.get_backend().name == "torch"


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter (this process has JAX loaded by conftest):
    every module of the port imports, and neither ``jax`` nor any
    ``chunky_bits_tpu`` module is loaded after."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import chunky_bits_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'chunky_bits_tpu' or m.startswith('chunky_bits_tpu.')]\n"
        "assert len(names) >= 12, names\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHUNKY_BITS_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_read_only_own_env(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "chunky_bits_tpu"), (path, name)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("CHUNKY_BITS_")):
            assert node.value.startswith("CHUNKY_BITS_TORCH_"), (path, node)
        if path.name != "tunables.py":
            assert not (isinstance(node, ast.Attribute)
                        and node.attr in ("environ", "getenv")), path
