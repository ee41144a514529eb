#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the kernels of ``chunky_bits_tpu_torch`` from ``csrc/`` (nvcc, at
first use, into ``chunky_bits_tpu_torch/_build/``), holds each kernel
byte for byte against its plain PyTorch version on the card, then drives
the erasure plane's main path at the repo's geometry (d=10, p=4, 1 MiB
chunks): ingest of 256 parts through ``ErasureCoder.encode_hash_batch``
with host and device SHA, a degraded read with shards 0, 1, 12 and 13
lost, and concurrent requests through both batchers.  Each of those paths
runs with the kernels' launch counts set to 0 just before it, and must
launch what its blocks and dispatches call for.  Then it holds each kernel
against its plain version at the main path's shapes and times both beside
the kernel's bound; the SHA bound counts the instructions of one
compression, checked against the compiled loop (``cuobjdump -sass``).

Every phase raises on failure; nothing is caught.  The last lines are a
JSON object per kernel and ``{"ok": true, "device": {...}}``.  Without
CUDA it exits 2 and prints no result.  Imports nothing of JAX or of
``chunky_bits_tpu``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20261016
D, P, CHUNK = 10, 4, 1 << 20
INGEST_PARTS = 256   # BASELINE.md config 2's batch: two blocks of the walk
KERNEL_PARTS = 128   # parts per block of the walk: the kernels' launch shape
LOST = (0, 1, 12, 13)

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and dense int8 tensor
# ops/s.  The sheet's 67 TFLOP/s of float32 is 132 SMs x 128 lanes x 2 (an
# FMA) x 1.98 GHz; an SM issues int32 ops on 64 lanes, so 132 x 64 x 1.98e9.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: SASS opcode families that do a compression's arithmetic
ALU_OPCODES = ("SHF", "LOP3", "IADD3", "IMAD", "PRMT", "IADD", "VIADD",
               "LEA", "SEL")


def log(msg: str) -> None:
    print(msg, flush=True)


def gib_s(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 2**30


def hashlib_rows(rows: np.ndarray) -> np.ndarray:
    """SHA-256 of every row of ``rows[..., S]`` with hashlib, on all cores."""
    flat = rows.reshape(int(np.prod(rows.shape[:-1])), rows.shape[-1])
    with ThreadPoolExecutor() as pool:
        digests = list(pool.map(lambda r: hashlib.sha256(r).digest(), flat))
    return np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(
        rows.shape[:-1] + (32,))


def lost_for(d: int, p: int) -> list[int]:
    if (d, p) == (D, P):
        return list(LOST)
    half = p // 2
    return list(range(half)) + list(range(d + p - (p - half), d + p))


def time_cuda(torch, fn, reps: int = 5, warm: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card over ``reps`` runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sass_loop_mix(lib: str) -> dict:
    """Opcode families and their counts in the SHA kernel's loop over
    16-byte-aligned rows (the loop with 128-bit loads), read from
    ``cuobjdump -sass`` of the built library: one compression as the
    card runs it."""
    from chunky_bits_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    assert text.count("Function :") == 1, "want one kernel in the library"
    ins = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*(0x[0-9a-f]+)?", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = [[op for a, op, _ in ins if int(tgt, 16) <= a <= addr]
             for addr, op, tgt in ins
             if op == "BRA" and tgt and int(tgt, 16) < addr]
    vec = [body for body in loops
           if any(op.startswith("LDG") and ".128" in op for op in body)]
    assert len(vec) == 1, f"want one loop with 128-bit loads, got {len(vec)}"
    mix: dict[str, int] = {}
    for op in vec[0]:
        mix[op.split(".")[0]] = mix.get(op.split(".")[0], 0) + 1
    return mix


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    return smi


def phase_build() -> None:
    from chunky_bits_tpu_torch.ops import _build

    _build.build_all()
    log(f"build: {_build.BUILD_SECONDS:.1f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(torch, dev) -> None:
    """Both kernels against their plain versions on the card, byte-exact,
    and against the host oracles."""
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix, sha256
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    rng = np.random.default_rng(SEED)
    oracle = NumpyBackend()
    cases = 0
    for d, p in ((D, P), (3, 2), (16, 8)):
        enc = matrix.build_encode_matrix(d, p)
        lost = lost_for(d, p)
        present = [i for i in range(d + p) if i not in lost][:d]
        dec = matrix.decode_matrix(enc, present, lost)
        for s in (1, 17, 1000, 4096):
            for b in (1, 3):
                data = rng.integers(0, 256, (b, d, s), dtype=np.uint8)
                x = torch.from_numpy(data).to(dev)
                t_enc = gf_kernel.to_device_matrix(enc[d:], dev)
                parity = gf_kernel.apply_matrix(t_enc, x)
                plain = gf_kernel.apply_matrix_plain(t_enc, x)
                want = oracle.apply_matrix(enc[d:], data)
                assert torch.equal(parity, plain), (d, p, s, b, "encode")
                assert np.array_equal(parity.cpu().numpy(), want)
                full = torch.cat([x, parity], dim=1)
                picked = full[:, present].contiguous()
                t_dec = gf_kernel.to_device_matrix(dec, dev)
                rebuilt = gf_kernel.apply_matrix(t_dec, picked)
                assert torch.equal(rebuilt,
                                   gf_kernel.apply_matrix_plain(t_dec, picked))
                assert torch.equal(rebuilt, full[:, lost]), (d, p, s, b)
                cases += 1
        # a base pointer off 16-byte alignment takes the byte path
        buf = torch.from_numpy(rng.integers(
            0, 256, 3 * d * 4096 + 1, dtype=np.uint8)).to(dev)
        x = buf[1:].view(3, d, 4096)
        t_enc = gf_kernel.to_device_matrix(enc[d:], dev)
        assert torch.equal(gf_kernel.apply_matrix(t_enc, x),
                           gf_kernel.apply_matrix_plain(t_enc, x))
        cases += 1
    torch.cuda.synchronize()
    log(f"gf_apply: {cases} cases equal to the plain version and numpy")

    shapes = [(1, 0), (1, 1), (2, 55), (3, 56), (2, 64), (4, 100), (2, 192),
              (3, 1000)]
    for n, s in shapes:
        rows = np.random.default_rng(s).integers(0, 256, (n, s),
                                                 dtype=np.uint8)
        x = torch.from_numpy(rows).to(dev)
        got = sha256.sha256_rows(x)
        assert torch.equal(got, sha256.sha256_rows_plain(x)), (n, s)
        assert np.array_equal(got.cpu().numpy(), hashlib_rows(rows)), (n, s)
    a = torch.from_numpy(rng.integers(0, 256, (3, D, 1000),
                                      dtype=np.uint8)).to(dev)
    b = torch.from_numpy(rng.integers(0, 256, (3, P, 1000),
                                      dtype=np.uint8)).to(dev)
    both = sha256.sha256_parts(a, b)
    want = hashlib_rows(torch.cat([a, b], dim=1).cpu().numpy())
    assert np.array_equal(both.cpu().numpy(), want)
    torch.cuda.synchronize()
    log(f"sha256_rows: {len(shapes)} row lengths and the two-source form "
        f"equal to the plain version and hashlib")


def phase_ingest(coder, data: np.ndarray, device_sha: bool):
    """encode_hash_batch at full size on one route, twice (the first call
    also allocates the pinned staging)."""
    coder.backend.device_sha = device_sha
    for attempt in ("first", "second"):
        t0 = time.perf_counter()
        parity, digests = coder.encode_hash_batch(data)
        dt = time.perf_counter() - t0
        log(f"ingest device_sha={device_sha} ({attempt} call): "
            f"[{data.shape[0]}, {D}, {CHUNK}] in {dt * 1e3:.1f} ms, "
            f"{gib_s(data.nbytes, dt):.2f} GiB/s of data")
    coder.backend.device_sha = None
    assert parity.shape == (data.shape[0], P, CHUNK)
    assert digests.shape == (data.shape[0], D + P, 32)
    return parity, digests


def check_ingest(coder, data: np.ndarray, host: tuple, dev: tuple) -> None:
    """Both routes' parity against each other and numpy, every digest
    against hashlib."""
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    (p_host, d_host), (p_dev, d_dev) = host, dev
    assert np.array_equal(p_host, p_dev), "parity differs between routes"
    sample = np.random.default_rng(SEED).choice(data.shape[0], 8,
                                                replace=False)
    want = NumpyBackend().apply_matrix(coder.parity_rows, data[sample])
    assert np.array_equal(p_host[sample], want), "parity != numpy oracle"
    want = np.concatenate([hashlib_rows(data), hashlib_rows(p_host)], axis=1)
    assert np.array_equal(d_host, want), "host-route digests != hashlib"
    assert np.array_equal(d_dev, want), "device digests != hashlib"
    log(f"ingest: parity equal on both routes and to numpy on "
        f"{len(sample)} parts; all {want.shape[0] * want.shape[1]} digests "
        f"equal to hashlib on both routes")


def picked_rows(data: np.ndarray, parity: np.ndarray) -> tuple:
    present = [i for i in range(D + P) if i not in LOST]
    use = present[:D]
    rows = [data[:, i] if i < D else parity[:, i - D] for i in use]
    return present, np.stack(rows, axis=1)


def phase_degraded(coder, data: np.ndarray, parity: np.ndarray) -> None:
    present, picked = picked_rows(data, parity)
    t0 = time.perf_counter()
    rebuilt = coder.reconstruct_batch_picked(picked, present, list(LOST))
    dt = time.perf_counter() - t0
    want = np.stack([data[:, i] if i < D else parity[:, i - D]
                     for i in LOST], axis=1)
    assert np.array_equal(rebuilt, want), "rebuilt rows differ"
    log(f"degraded read: rebuilt shards {list(LOST)} of {data.shape[0]} "
        f"parts byte-identical in {dt * 1e3:.1f} ms, "
        f"{gib_s(picked.nbytes, dt):.2f} GiB/s of surviving data read")


REQUESTS = 16  # concurrent requests per batcher


def phase_batch_encode(data: np.ndarray, parity: np.ndarray,
                       digests: np.ndarray):
    from chunky_bits_tpu_torch.ops.batching import EncodeHashBatcher

    async def drive():
        enc = EncodeHashBatcher()
        outs = await asyncio.gather(*(
            enc.encode_hash(D, P, data[8 * i:8 * i + 8])
            for i in range(REQUESTS)))
        await enc.aclose()
        return enc, outs

    enc, outs = asyncio.run(drive())
    for i, (par, dig) in enumerate(outs):
        assert np.array_equal(par, parity[8 * i:8 * i + 8])
        assert np.array_equal(dig, digests[8 * i:8 * i + 8])
    log(f"EncodeHashBatcher: {REQUESTS} requests of [8, {D}, {CHUNK}] -> "
        f"{enc.dispatches} dispatch(es), {enc.groups} group(s), "
        f"byte-identical")
    assert enc.dispatches < REQUESTS
    return enc


def phase_batch_reconstruct(data: np.ndarray, parity: np.ndarray):
    from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher

    arrays = [[None if j in LOST else
               (data[i, j] if j < D else parity[i, j - D])
               for j in range(D + P)] for i in range(REQUESTS)]

    async def drive():
        rec = ReconstructBatcher()
        filled = await asyncio.gather(*(rec.reconstruct(D, P, a)
                                        for a in arrays))
        await rec.aclose()
        return rec, filled

    rec, filled = asyncio.run(drive())
    for i, rows in enumerate(filled):
        for j in LOST:
            want = data[i, j] if j < D else parity[i, j - D]
            assert np.array_equal(rows[j], want), (i, j)
    log(f"ReconstructBatcher: {REQUESTS} requests sharing erasure pattern "
        f"{list(LOST)} -> {rec.dispatches} dispatch(es), {rec.groups} "
        f"group(s), byte-identical")
    assert rec.dispatches < REQUESTS
    return rec


def phase_timings(torch, dev, coder, data: np.ndarray,
                  parity: np.ndarray) -> list[dict]:
    """Each kernel at the main path's launch shape beside its plain
    version and its bound.  No single PyTorch call computes either
    function, so ``library_ms`` is null."""
    from chunky_bits_tpu_torch.ops import _build, gf_kernel, matrix, sha256

    b, s = KERNEL_PARTS, CHUNK
    x = torch.from_numpy(data[:b]).to(dev)
    t_enc = gf_kernel.to_device_matrix(coder.parity_rows, dev)
    present, picked = picked_rows(data[:b], parity[:b])
    y = torch.from_numpy(picked).to(dev)
    t_dec = gf_kernel.to_device_matrix(
        matrix.decode_matrix(coder.encode_matrix, present, list(LOST)), dev)

    got = gf_kernel.apply_matrix(t_enc, x)
    plain = gf_kernel.apply_matrix_plain(t_enc, x)
    err = int((got.int() - plain.int()).abs().max())
    dec_got = gf_kernel.apply_matrix(t_dec, y)
    dec_plain = gf_kernel.apply_matrix_plain(t_dec, y)
    err = max(err, int((dec_got.int() - dec_plain.int()).abs().max()))
    del plain, dec_plain
    ms = time_cuda(torch, lambda: gf_kernel.apply_matrix(t_enc, x))
    ms_dec = time_cuda(torch, lambda: gf_kernel.apply_matrix(t_dec, y))
    plain_ms = time_cuda(torch, lambda: gf_kernel.apply_matrix_plain(t_enc, x),
                         reps=3)
    plain_ms_dec = time_cuda(
        torch, lambda: gf_kernel.apply_matrix_plain(t_dec, y), reps=3)
    nbytes = b * D * s + b * P * s + t_enc.numel()
    ops = 2 * (8 * P) * (8 * D) * b * s  # the bit-plane product's int8 MACs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    gf = {"name": "gf_apply", "route": "cuda",
          "source": "chunky_bits_tpu_torch/csrc/gf_apply.cu",
          "replaces": "chunky_bits_tpu/ops/pallas_kernels.py:222",
          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": None, "shape": [b, D, s], "decode_ms": ms_dec,
          "decode_plain_ms": plain_ms_dec}
    log(f"gf_apply [{b}, {D}, {s}] -> [{b}, {P}, {s}]: encode {ms:.3f} ms, "
        f"4-erasure decode {ms_dec:.3f} ms; plain {plain_ms:.1f} / "
        f"{plain_ms_dec:.1f} ms; bound {gf['bound_ms']:.3f} ms "
        f"({gf['bound_by']}: {nbytes / 1e9:.2f} GB); max_abs_err {err} "
        f"against the plain version (tolerance 0: integer arithmetic); no "
        f"single PyTorch call computes it")

    par = got
    rows_n = b * (D + P)
    rows = torch.cat([x, par], dim=1).reshape(rows_n, s)
    host_rows = rows.cpu().numpy()
    digests = sha256.sha256_parts(x, par).reshape(rows_n, 32)
    assert np.array_equal(digests.cpu().numpy(), hashlib_rows(host_rows))
    ms_sha = time_cuda(torch, lambda: sha256.sha256_parts(x, par))
    held = []
    plain_sha = time_cuda(
        torch, lambda: held.append(sha256.sha256_rows_plain(rows)),
        reps=1, warm=0)
    sha_err = int((digests.int() - held[0].int()).abs().max())
    del held, rows
    blocks = sha256.blocks_per_row(s)
    mix = sass_loop_mix(_build.library_path("sha256_rows"))
    compiled = sum(n for op, n in mix.items() if op in ALU_OPCODES)
    per_block = min(sha256.OPS_PER_BLOCK, compiled)
    nbytes = rows_n * s + rows_n * 32
    ops = rows_n * blocks * per_block
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    sha = {"name": "sha256_rows", "route": "cuda",
           "source": "chunky_bits_tpu_torch/csrc/sha256_rows.cu",
           "replaces": "chunky_bits_tpu/ops/sha256_jax.py:213",
           "max_abs_err": sha_err, "ms": ms_sha, "plain_ms": plain_sha,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "shape": [rows_n, s],
           "ops_per_block": per_block, "sass_loop": mix}
    with ThreadPoolExecutor() as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda r: hashlib.sha256(r).digest(), host_rows))
        host_ms = (time.perf_counter() - t0) * 1e3
    log(f"sha256_rows compiled loop, one compression: {compiled} ALU "
        f"instructions ({mix}); counted by hand {sha256.OPS_PER_BLOCK}")
    log(f"sha256_rows [{rows_n}, {s}]: {ms_sha:.1f} ms; bound "
        f"{sha['bound_ms']:.3f} ms ({sha['bound_by']}: {ops:.3g} int32 ops"
        f" at {per_block} a block, {nbytes / 1e9:.2f} GB); hashlib on all "
        f"host cores {host_ms:.1f} ms; plain version {plain_sha:.1f} ms on "
        f"the same rows, max_abs_err {sha_err} (tolerance 0: integer "
        f"arithmetic); all digests equal hashlib; no single PyTorch call "
        f"computes it")
    return [gf, sha]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from chunky_bits_tpu_torch.ops import gf_kernel, sha256
    from chunky_bits_tpu_torch.ops.backend import get_coder

    dev = torch.device("cuda", 0)
    smi = phase_device(torch)
    phase_build()
    phase_kernels(torch, dev)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randint(0, 256, (INGEST_PARTS, D, CHUNK), generator=gen,
                         dtype=torch.uint8, device=dev).cpu().numpy()
    coder = get_coder(D, P)
    assert coder.backend.name == "cuda", coder.backend.name

    # each path of the main path runs with both counts set to 0 just
    # before it and read just after, and must launch what it should
    counts: dict[str, dict[str, int]] = {}

    def path(name: str, fn, *args):
        gf_kernel.LAUNCHES = 0
        sha256.LAUNCHES = 0
        out = fn(*args)
        counts[name] = {"gf_apply": gf_kernel.LAUNCHES,
                        "sha256_rows": sha256.LAUNCHES}
        return out

    be = coder.backend
    walk = -(-INGEST_PARTS // (be.max_block_bytes // (D * CHUNK)))
    fused = -(-INGEST_PARTS // (be.max_fused_block_bytes
                                // ((D + P) * CHUNK)))
    host = path("ingest_host_sha", phase_ingest, coder, data, False)
    dev_route = path("ingest_device_sha", phase_ingest, coder, data, True)
    check_ingest(coder, data, host, dev_route)
    parity, digests = host
    path("degraded_read", phase_degraded, coder, data, parity)
    enc = path("batch_encode", phase_batch_encode, data, parity, digests)
    rec = path("batch_reconstruct", phase_batch_reconstruct, data, parity)
    # two calls per ingest route; every batcher dispatch holds <= 128
    # parts, one block of the walk
    expected = {
        "ingest_host_sha": {"gf_apply": 2 * walk, "sha256_rows": 0},
        "ingest_device_sha": {"gf_apply": 2 * fused,
                              "sha256_rows": 2 * fused},
        "degraded_read": {"gf_apply": walk, "sha256_rows": 0},
        "batch_encode": {"gf_apply": enc.dispatches, "sha256_rows": 0},
        "batch_reconstruct": {"gf_apply": rec.dispatches, "sha256_rows": 0},
    }
    for name, got in counts.items():
        log(f"launches on {name}: {got}")
    assert counts == expected, (counts, expected)

    kernels = phase_timings(torch, dev, coder, data, parity)
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in counts.values())
        k["launches_by_path"] = {n: c[k["name"]] for n, c in counts.items()}
        assert k["launches"] > 0 and k["max_abs_err"] == 0, k
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
