#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # one card, every phase below
    python3 chip_smoke.py --all-gpus   # the mesh backends over every card

(``--multihost-worker`` is the child process of the multi-host step, and
``--sanitizer-worker`` that of the sanitizer group.)

Builds the five kernels of ``chunky_bits_tpu_torch`` from ``csrc/`` (nvcc,
at first use, into ``chunky_bits_tpu_torch/_build/``; the host codec
``gf256.cpp`` by g++ beside them) and holds each
against its plain PyTorch version on the card, byte for byte (int16
element for element for the accumulator K2): K1 (``gf_apply``) also
against numpy at its edges (R 1-9 and 16, K 1-33, 64 and 255, S 1-4097,
unaligned input and output); the packed GF kernel against ``gf_apply`` and
numpy at its gate's corners; the reduce-and-pack (``gf_acc_pack``) against
a numpy sum and pack at tp 1, 2, 4 and 8; K2's rank partials, reduced and
packed, against ``gf_apply`` and numpy at BASELINE.md config 5.  Then it
drives the main paths:

* the erasure plane at the repo's geometry (d=10, p=4, 1 MiB chunks):
  ingest of 256 parts through ``ErasureCoder.encode_hash_batch`` with
  host and device SHA, a degraded read with shards 0, 1, 12 and 13 lost,
  and concurrent requests through both batchers; once with the packed
  kernel off and once on, with the same bytes;
* the object codec: BASELINE.md config 2, a 10 GiB stream (plus a
  777-byte tail part) through ``FileWriteBuilder`` over the void
  destination, packed off and on, with equal file references; and a
  ~1 GiB object over 14 ``path`` destinations in a temporary directory:
  write, read, delete the chunk files of shards 0, 1, 12 and 13 of every
  part, read again, verify, resilver, verify and read a third time, every
  read byte-identical to the source;
* the multi-device plane on 8 logical devices of the card (a stream
  each, what ``CHUNKY_BITS_TORCH_VIRTUAL_DEVICES=8`` gives): the ``mesh``
  backend through ``encode_hash_batches`` and the decode in its three
  layouts (config 5 at b=2: dp2/tp4 with K2; config 5 at b=16: dp8;
  d=10 p=4 at b=1: sp8), with the dispatch window's overlap counters;
  config 5 through ``cuda:dp2,tp4``: a 10 GiB ingest whose file reference
  equals the ``cuda`` backend's, and a ~1 GiB round trip over 26 path
  destinations with shards 0, 5, 9, 21, 23 and 25 of every part lost;
* the ``cluster_cli`` group, the port's CLI (``cli.main.main``) in this
  process over cluster YAMLs on the local disk: config 2 with ``backend:
  cuda`` (~512 MiB: cp, cat, verify, shards 0, 1, 12 and 13 of every part
  deleted, verify, resilver, verify, cat, then ls, file-info, get-hashes
  and find-unused-hashes against the reference on disk); config 5 with
  the JAX package's ``backend: "jax:dp2,tp4"`` (cp, cat, 6 shards lost,
  resilver, cat); ``code: pm-msr`` at d=5 p=4 (~256 MiB: cp, cat, one
  chunk of every part lost, resilver, cat); and ``python -m
  chunky_bits_tpu_torch`` cp and cat in a subprocess on the default
  backend.  Every cat equals the source;
* the ``gateway`` group, the port's HTTP gateway: config 2 through
  ``gateway.serve`` on a thread of this process (PUT of ~1 GiB with a
  streamed body, GET, HEAD and the ETag, ``If-None-Match`` -> 304, an
  in-chunk Range (the sendfile path) and a cross-part one, a Range past
  the end -> 416, shards 0, 1, 12 and 13 of every part deleted and GET
  again, ``/metrics`` through the port's parser, ``python -m
  chunky_bits_tpu_torch stats``); BASELINE.md config 9's mix (d=3 p=2,
  64 KiB chunks, a 2 MiB read cache; 200 keep-alive clients x 5 rounds
  of hot, ranged, conditional, cold and large reads, every body held
  against its source); ``http-gateway --workers 2`` in a subprocess,
  through a worker's SIGKILL and the supervisor's SIGINT; and a config-2
  cluster of ``http://`` destinations on a chunk node served from this
  process (~256 MiB: cp, cat, shards 0, 1, 12 and 13 of every part
  deleted on the node, cat, resilver, verify, cat);
* the ``storage`` group, slab destinations, meta-log metadata, scrub and
  the repair planner: config 2 through the CLI in this process over 7
  ``slab:`` + 7 ``path`` destinations with ``metadata: {type:
  meta-log}`` and 4 KiB digest blocks (~512 MiB: cp, one flipped byte in
  one chunk of 20 parts and the only replica of a whole chunk dropped in
  10 others, ``scrub --once`` with exact scrub and repair counts, verify,
  cat, meta-compact, ls, find-unused-hashes over the slab and path
  roots); BASELINE.md config 11 (200 objects of 3 x 64 KiB, 40 flipped
  bytes, one planner pass with a profiler: 40 decode plans, 480 KiB of
  helper reads); config 13's rs and pm-msr legs (120 objects of 5 x 16
  KiB, 30 lost chunks: 2400 and 960 KiB of helper bytes); and config
  11's cluster served by ``gateway.serve`` with ``scrub_bytes_per_sec``
  set until ``/scrub/status`` shows the pass that repaired it; config 2's
  scrub and verify hash every local and slab replica through the native
  fused read+hash, and the planner localizes each flipped chunk;
* the ``host_codec`` group, the native host codec (``csrc/gf256.cpp``,
  built by g++ beside the kernels): its build, tiers and the CPU's flags;
  config 2's ingest (cut to ~1 GiB) on ``cuda`` with the native SHA-NI
  row hasher on the shared host pipeline, its references equal to
  ``native`` and ``numpy`` runs on a 16-part cut; cp, cat and verify
  through the CLI on a ``backend: native:4`` YAML (the reference equal to
  the ``cuda`` YAML's); and BASELINE.md config 12's grid on ``native``,
  the table kernels and the scheduled-XOR engine each byte-identical to
  numpy, at host GiB/s of the card box's CPU;
* the ``serving_opt_in`` group, the serving plane's opt-in parts and the
  multi-host bootstrap: BASELINE.md config 19's QoS A/B through a
  gateway on ``cuda`` (d=3 p=2, 64 KiB chunks, ``max_concurrent_gets``
  4, 16 flooding clients of tenant ``other`` and a paced victim tenant
  of weight 4 reading 512 KiB 40 times; QoS off, then on; the ON leg
  sheds no victim read and its ``cb_qos_*`` samples equal the
  scheduler's ``stats()``); config 15's engine-off overhead (400 hot
  GETs a leg, the SLO engine off, on, on, off); a live ``availability``
  alert (short windows, one GET body at a time, a flood of sheds: it
  fires within ``slow_s`` + 1 s, /alerts, /metrics, /stats and ``stats
  --json`` agree, and it resolves under healthy GETs); and two processes
  joined by ``init_multihost`` over gloo, each encoding its
  ``partition_parts`` slice of 256 config-2 parts on ``local_mesh(sp=2)``
  over 4 logical devices of the card, the parity equal to the
  single-process ``cuda`` coder's;
* the ``simulator`` group, the cluster simulator on ``cuda`` (its
  clusters name no backend): BASELINE.md config 14's ten scenarios at
  N=100, seed 0, every verdict true (a fault fabric of ``sim:``
  locations behind the real cluster, scrub and repair, on the
  virtual-time loop); ``az_outage`` at N=1000; ``az_outage`` at N=100
  again on ``cuda`` and once on ``torch``, the three traces byte-identical
  and both ``cuda`` metrics snapshots equal; config 15's detection leg
  (every expected alert within its bound and resolved, no other firing,
  ``thundering_herd`` twice with equal reports and traces); config 16's
  crash matrix over its eight mutations twice (every image clean, one
  digest) and its cluster recovery (``scrub --once`` brings every crash
  image to Valid);
* the ``sanitizer`` group, the runtime concurrency sanitizer
  (``analysis/sanitizer.py``) and the linter: config 2's ~1 GiB ingest
  through ``FileWriteBuilder`` and a ``HostPipeline`` to the void
  destination, the same stream on 14 path destinations read back with
  shards 0, 1, 12 and 13 of every part lost, ``gateway.serve`` at config
  19's geometry with QoS on (a PUT, 10 s of the config-19 flood, a Range
  GET and a 304) and ``az_outage`` at N=100, seed 0; first in this
  process with the sanitizer off, then in a child (``--sanitizer-worker``)
  with ``CHUNKY_BITS_TORCH_SANITIZE=1``, whose report must be clean (0
  leaked tasks, 0 unretrieved exceptions, 0 handoff violations), whose
  every step must record a handoff submit, and whose scenario trace must
  equal the sanitize-off one byte for byte; then ``python -m
  chunky_bits_tpu_torch.analysis --json --graph-stats`` (rc 0, 0 new
  findings) and each rule family alone, timed;
* the ``baseline_ab`` group, the JAX package's A/Bs of BASELINE.md
  configs 4, 6, 7, 8, 10, 18 and 17 (``bench.py``) through the port's
  entry points on ``cuda``: config 4's 1,024 objects of [1, 8, 512 KiB],
  16 in flight through one ``EncodeHashBatcher``, host SHA then the SHA
  kernel (parity equal to numpy, digests to hashlib); config 6's 64 MiB
  object read 5 times with the chunk cache off and on (the cached reads
  decode nothing); config 7's 512 MiB PUT through ``make_app`` at
  ``host_threads`` 1 and 2, best of 2, every object read back; config
  8's hedged-read A/B on five chunk nodes served from this process, node
  0 slowed 100 ms (no hedge off, the budget held on, the on leg's p99
  below the off leg's); config 10's 150 small objects through ``path``
  and ``slab:`` clusters with equal GC candidate sets; config 18's 2,500
  references through the path store and the meta-log (equal listings and
  liveness sets); config 17's ``cuda`` against ``mesh`` at depth 2 and 0
  on 8 logical devices (the window overlaps at depth 2 only);
* the ``conformance`` group, the seeded geometries of the conformance
  fuzz (``tests/test_conformance_fuzz.py``: 20 Reed-Solomon cells with
  their erasure patterns, 14 pm-msr cells with their repairs, 4 cells
  past p erasures and 4 storage geometries) through every kernel: K1 on
  ``cuda``; the packed kernel on, each cell also at its length rounded
  up to 256 bytes (K3 inside its gate); ``mesh`` and ``cuda:dp2,tp4`` on
  the 8 logical devices (K2 and the reduce-and-pack, each also alone
  against its plain version); pm-msr on ``cuda``; encode+hash with device
  SHA; objects of 0 and 1 bytes and of a stripe less one, one stripe, a
  stripe and one and three stripes and a tail through ``slab:`` and path
  clusters; and more than p erasures, which must raise ``ErasureError``
  and launch nothing.  Every output equals numpy (hashlib for digests)
  and the kernel's plain version on the card.  Then ``python -m
  chunky_bits_tpu_torch config-info`` in a child, timed, must load no
  torch.

Each of those paths runs with the kernels' launch counts set to 0 just
before it, and must launch what its blocks and dispatches call for (a
mesh block launches one kernel per logical device with work, and a tp
block one reduce-and-pack per 'dp' group).  Then it times each kernel
beside its plain version and its bound (K1 also at the one-part shapes of
the read dispatches, at config 5's stripe, at the repair planner's
commonest shapes and at the d=3 p=2 decode shapes of config 19's and the
simulator's reads, and at configs 4's and 8's dispatches; the SHA kernel
also at config 4's rows); the SHA bound
counts the instructions of one compression, checked against the compiled
loop (``cuobjdump -sass``).

Every phase raises on failure; nothing is caught.  The last lines are
the card's name and power limit, one JSON object with a row per kernel,
and ``{"ok": true, "device": {...}}``.  Without
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
from dataclasses import dataclass

import numpy as np

SEED = 20261016
D, P, CHUNK = 10, 4, 1 << 20
INGEST_PARTS = 256   # BASELINE.md config 2's batch: two blocks of the walk
KERNEL_PARTS = 128   # parts per block of the walk: the kernels' launch shape
LOST = (0, 1, 12, 13)


@dataclass(frozen=True)
class Geometry:
    """A stripe geometry of BASELINE.md: d data + p parity shards of
    ``chunk`` bytes, and the shards a degraded read loses."""

    d: int
    p: int
    chunk: int
    lost: tuple


#: configs 2 and 3: the repo's main geometry
CONFIG2 = Geometry(D, P, CHUNK, LOST)
#: config 5: the wide stripe; the erasures of tests/test_parallel.py:367
CONFIG5 = Geometry(20, 6, 4 << 20, (0, 5, 9, 21, 23, 25))
#: the config-5 batch K2 is checked and timed at, and its tp extent
ACC_PARTS, TP = 8, 4

#: every kernel of the port, by the name its launch count goes under
KERNELS = ("gf_apply", "gf_apply_packed", "gf_acc", "gf_acc_pack",
           "sha256_rows")

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and dense int8 tensor
# ops/s.  The sheet's 67 TFLOP/s of float32 is 132 SMs x 128 lanes x 2 (an
# FMA) x 1.98 GHz; an SM issues int32 ops on 64 lanes, so 132 x 64 x 1.98e9.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# The sheet gives no rate for the binary (b1) tensor cores.  Their mma
# shapes take k = 256 one-bit products where the int8 ones take k = 32 at
# the same m x n and issue rate, so a GF(2) product's AND-POPC MACs are
# counted at eight times the int8 rate.
B1_TENSOR_OPS_PER_S = 8 * INT8_TENSOR_OPS_PER_S
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ


def gf_apply_bound(n: int, k: int, r: int, s: int,
                   table_bytes: int = 0) -> tuple[float, str]:
    """K1's least time in ms for ``[n, k, s] -> [n, r, s]``, and what sets
    it: each byte read and written once at the HBM rate, or the 0/1
    bit-matrix product's ``(8r) x (8k)`` MACs per column on the b1 tensor
    cores, whichever is longer."""
    t_bytes = (n * (k + r) * s + table_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (8 * r) * (8 * k) * n * s / B1_TENSOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

#: SASS opcode families that issue to a sub-partition's integer pipe, 16
#: lanes wide, so one every other cycle for a warp (IMAD goes to the FMA
#: pipe)
INT_PIPE_OPCODES = ("SHF", "LOP3", "IADD3", "PRMT", "IADD", "LEA", "SEL",
                    "ISETP")


def sha_chain_floor(mix: dict, per_pass: int, blocks: int) -> tuple:
    """The SHA kernel's floor on one warp: ``blocks`` compressions one
    after another, each taking at least one cycle per instruction of the
    consumer's loop and two per integer-pipe instruction, at
    ``SM_CLOCK_HZ``.  Returns (ms, instructions, integer-pipe
    instructions), the counts per compression."""
    issued = sum(mix.values()) / per_pass
    int_pipe = sum(n for op, n in mix.items()
                   if op in INT_PIPE_OPCODES) / per_pass
    cycles = max(issued, 2 * int_pipe)
    return blocks * cycles / SM_CLOCK_HZ * 1e3, issued, int_pipe


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def stamp(label: str) -> None:
    """Log the seconds since the script started, after ``label``."""
    log(f"[{time.perf_counter() - _START:.1f} s] {label} done")


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


def time_cuda(torch, fn, reps: int = 5, warm: int = 1,
              inner: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card over ``reps`` runs, each
    run ``inner`` calls back to back between the events (divided out), so
    that a kernel of a fraction of a millisecond is not timed by the
    host's time to launch it."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def sass_loop_mix(lib: str) -> tuple[dict, int]:
    """Opcode families and their counts in one pass of the SHA kernel's
    consumer loop, read from ``cuobjdump -sass`` of the built library:
    the one loop that reads 128-bit words from shared memory and loads
    nothing from device memory (the producer's loops do).  Returns the
    mix and the compressions one pass holds (16 shared loads each), so
    that mix / compressions is one compression's rounds as the card
    issues them."""
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
    rounds = [body for body in loops
              if any(op.startswith("LDS") and ".128" in op for op in body)
              and not any(op.startswith("LDG") for op in body)]
    assert len(rounds) == 1, (
        f"want one loop with 128-bit shared loads and no global load, got "
        f"{len(rounds)}")
    mix: dict[str, int] = {}
    for op in rounds[0]:
        mix[op.split(".")[0]] = mix.get(op.split(".")[0], 0) + 1
    lds = sum(1 for op in rounds[0] if op.startswith("LDS") and ".128" in op)
    assert lds % 16 == 0, f"{lds} shared loads: not whole compressions"
    return mix, lds // 16


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
    """Every CUDA kernel (nvcc, in parallel) and, beside them, the host
    codec ``csrc/gf256.cpp`` (g++), from the checkout's sources."""
    from chunky_bits_tpu_torch.ops import _build

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(_build.host_library)
        _build.build_all()
        host.result()
    log(f"build: {_build.BUILD_SECONDS:.1f} s; host codec "
        f"{_build.HOST_BUILD['seconds'] or 0:.1f} s "
        f"({_build.HOST_BUILD['flags'] or 'cached'})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(torch, dev) -> None:
    """Both kernels against their plain versions on the card, byte-exact,
    and against the host oracles."""
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix
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

    phase_apply_edges(torch, dev)
    phase_sha_edges(torch, dev)


#: K1's edge cases: output rows around its passes of 4 and 8 byte-rows,
#: input rows around its k-steps of 16 and 32 rows and up to 255, lengths
#: around its 16-byte words and 128-column units
APPLY_RS = tuple(range(1, 10)) + (16,)
APPLY_KS = tuple(range(1, 34)) + (64, 255)
APPLY_LENGTHS = (1, 15, 16, 17, 127, 128, 129, 777, 4096, 4097)


def phase_apply_edges(torch, dev) -> int:
    """K1 against its plain version and numpy, byte for byte: every R of
    ``APPLY_RS`` by every K of ``APPLY_KS`` (S taken in turn from
    ``APPLY_LENGTHS``, B 1 and 3 in turn); every S at four (R, K); the
    input, the output and both off 16-byte alignment (the C interface
    called directly for an unaligned output); and config 5's
    ``[8, 20, 4 MiB]``.  Returns the cases."""
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    rng = np.random.default_rng(SEED + 9)
    oracle = NumpyBackend()
    fn, _ = gf_kernel._library("gf_apply")
    cases = 0

    def check(mat: np.ndarray, data: np.ndarray, x=None, out_offset=None):
        nonlocal cases
        table = gf_kernel.to_device_matrix(mat, dev)
        if x is None:
            x = torch.from_numpy(data).to(dev)
        b, k, s = x.shape
        if out_offset is None:
            got = gf_kernel.apply_matrix(table, x)
        else:  # an output base off alignment: the C interface itself
            buf = torch.empty(b * mat.shape[0] * s + out_offset,
                              dtype=torch.uint8, device=dev)
            got = buf[out_offset:].view(b, mat.shape[0], s)
            assert fn(table.data_ptr(), x.data_ptr(), got.data_ptr(), b, k,
                      mat.shape[0], s,
                      torch.cuda.current_stream(dev).cuda_stream) == 0
        assert torch.equal(got, gf_kernel.apply_matrix_plain(table, x)), (
            mat.shape, tuple(x.shape))
        assert np.array_equal(got.cpu().numpy(),
                              oracle.apply_matrix(mat, data)), (
            mat.shape, data.shape)
        cases += 1

    n = 0
    for r in APPLY_RS:
        for k in APPLY_KS:
            s = APPLY_LENGTHS[n % len(APPLY_LENGTHS)]
            b = 1 + 2 * (n % 2)
            n += 1
            check(rng.integers(0, 256, (r, k), dtype=np.uint8),
                  rng.integers(0, 256, (b, k, s), dtype=np.uint8))
    for r, k in ((4, 10), (6, 20), (9, 33), (1, 1)):
        for s in APPLY_LENGTHS:
            check(rng.integers(0, 256, (r, k), dtype=np.uint8),
                  rng.integers(0, 256, (1, k, s), dtype=np.uint8))
    for r, k, s in ((4, 10, 4096), (6, 20, 4097), (3, 40, 1000)):
        mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
        flat = rng.integers(0, 256, 3 * k * s + 1, dtype=np.uint8)
        x = torch.from_numpy(flat).to(dev)
        aligned = flat[:-1].reshape(3, k, s)
        check(mat, flat[1:].reshape(3, k, s), x[1:].view(3, k, s))
        check(mat, aligned, x[:-1].view(3, k, s), out_offset=1)
        check(mat, flat[1:].reshape(3, k, s), x[1:].view(3, k, s),
              out_offset=3)
    g = CONFIG5
    enc = matrix.build_encode_matrix(g.d, g.p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randint(0, 256, (ACC_PARTS, g.d, g.chunk), generator=gen,
                      dtype=torch.uint8, device=dev)
    table = gf_kernel.to_device_matrix(enc[g.d:], dev)
    got = gf_kernel.apply_matrix(table, x)
    assert torch.equal(got, gf_kernel.apply_matrix_plain(table, x))
    numpy_windows(enc[g.d:], x.cpu().numpy(), got.cpu().numpy())
    cases += 1
    torch.cuda.synchronize()
    log(f"gf_apply edges: {cases} cases (R {APPLY_RS} x K {APPLY_KS} with S "
        f"from {APPLY_LENGTHS}, every S at four (R, K), unaligned input "
        f"and output, config 5 [{ACC_PARTS}, {g.d}, {g.chunk}]) equal to "
        f"the plain version and numpy")
    return cases


#: tp extents, and (B, R, S) shapes, the reduce-and-pack is checked at
PACK_TPS = (1, 2, 4, 8)
PACK_SHAPES = ((1, 6, 777), (3, 4, 4096), (1, 1, 1), (2, 9, 4097))


def phase_reduce_pack(torch, dev) -> None:
    """The reduce-and-pack kernel against its plain version and a numpy
    sum and pack, byte for byte: every tp of ``PACK_TPS`` at every shape of
    ``PACK_SHAPES`` with counts up to 8 * 255, and partials off 16-byte
    alignment (its scalar path)."""
    from chunky_bits_tpu_torch.ops import gf_kernel

    rng = np.random.default_rng(SEED + 11)
    cases = 0

    def check(parts, host) -> None:
        nonlocal cases
        got = gf_kernel.reduce_pack(parts)
        assert torch.equal(got, gf_kernel.reduce_pack_plain(parts)), (
            len(parts), tuple(parts[0].shape))
        b, r8, s = host[0].shape
        bits = (np.sum(np.stack(host), axis=0) & 1).reshape(b, 8, r8 // 8, s)
        want = np.sum(bits.astype(np.uint32) << np.arange(8, dtype=np.uint32)[
            None, :, None, None], axis=1).astype(np.uint8)
        assert np.array_equal(got.cpu().numpy(), want), (len(parts), b, s)
        cases += 1

    for tp in PACK_TPS:
        for b, r, s in PACK_SHAPES:
            host = [rng.integers(0, 8 * 255 // tp + 1, (b, 8 * r, s),
                                 dtype=np.int16) for _ in range(tp)]
            check([torch.from_numpy(h).to(dev) for h in host], host)
        host = [rng.integers(0, 2041, 2 * 48 * 4096 + 1, dtype=np.int16)
                for _ in range(tp)]
        check([torch.from_numpy(h).to(dev)[1:].view(2, 48, 4096)
               for h in host], [h[1:].reshape(2, 48, 4096) for h in host])
    torch.cuda.synchronize()
    log(f"gf_acc_pack: {cases} cases (tp {PACK_TPS} x (B, R, S) "
        f"{PACK_SHAPES}, unaligned partials) equal to its plain version and "
        f"a numpy sum and pack")


#: row lengths at the edges of the SHA kernel's padding and producer
SHA_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 4096 + 777)
#: rows per launch: one, a block's 32 lanes either side, the fused block
SHA_ROWS = (1, 31, 33)
FUSED_ROWS = KERNEL_PARTS * (D + P)


def phase_sha_edges(torch, dev) -> None:
    """The SHA kernel against its plain version and hashlib, byte for
    byte: every length of ``SHA_LENGTHS`` at 1, 31 and 33 rows, 1,792
    rows at three lengths, unaligned bases (the byte-wise producer), and
    the two-source form with gb = 0 and gb > 0."""
    from chunky_bits_tpu_torch.ops import sha256

    rng = np.random.default_rng(SEED + 1)
    cases = 0

    def check(x, want_rows: np.ndarray) -> None:
        nonlocal cases
        got = sha256.sha256_rows(x)
        assert torch.equal(got, sha256.sha256_rows_plain(x)), tuple(x.shape)
        assert np.array_equal(got.cpu().numpy(), hashlib_rows(want_rows)), (
            tuple(x.shape))
        cases += 1

    shapes = [(n, s) for s in SHA_LENGTHS for n in SHA_ROWS]
    for n, s in shapes + [(4, 100), (2, 192), (3, 1000)]:
        rows = rng.integers(0, 256, (n, s), dtype=np.uint8)
        check(torch.from_numpy(rows).to(dev), rows)
    for s in (64, 120, 4096 + 777):
        rows = rng.integers(0, 256, (FUSED_ROWS, s), dtype=np.uint8)
        check(torch.from_numpy(rows).to(dev), rows)
    for s in (4096, 4096 + 777, 65):  # base 1 byte off 16-byte alignment
        flat = rng.integers(0, 256, 33 * s + 1, dtype=np.uint8)
        buf = torch.from_numpy(flat).to(dev)
        check(buf[1:].view(33, s), flat[1:].reshape(33, s))
    for s in (1000, 4096):
        a = torch.from_numpy(rng.integers(0, 256, (3, D, s),
                                          dtype=np.uint8)).to(dev)
        flat = torch.from_numpy(rng.integers(0, 256, 3 * P * s + 1,
                                             dtype=np.uint8)).to(dev)
        for b in (None, flat[:-1].view(3, P, s), flat[1:].view(3, P, s)):
            got = sha256.sha256_parts(a, b)
            rows = a if b is None else torch.cat([a, b], dim=1)
            want = hashlib_rows(rows.cpu().numpy())
            assert np.array_equal(got.cpu().numpy(), want), (s, b is None)
            cases += 1
    torch.cuda.synchronize()
    log(f"sha256_rows: {cases} cases (lengths {SHA_LENGTHS} at "
        f"{SHA_ROWS} rows, {FUSED_ROWS} rows, unaligned bases, the "
        f"two-source form with gb = 0 and gb = {P}) equal to the plain "
        f"version and hashlib")


#: (d, p) of the packed kernel's gate corners and interior geometries
PACKED_GEOMETRIES = ((10, 4), (3, 2), (15, 8), (8, 8), (1, 1), (15, 1),
                     (1, 8), (12, 6))


def phase_packed_kernel(torch, dev) -> None:
    """The packed kernel against its plain version, K1 and numpy on the
    card, byte-exact: every (d, p) above at S of 256, 512 and 4096 and B of
    1, 2 and 3, encode and decode rows, random and all-0xFF shards, an
    unaligned base pointer; a geometry outside the gate raises."""
    from chunky_bits_tpu_torch.errors import ErasureError
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    rng = np.random.default_rng(SEED + 3)
    oracle = NumpyBackend()
    cases = 0

    def check(mat: np.ndarray, data: np.ndarray, x=None) -> np.ndarray:
        nonlocal cases
        table = gf_kernel.to_device_matrix(mat, dev)
        if x is None:
            x = torch.from_numpy(data).to(dev)
        got = gf_kernel.apply_matrix_packed(table, x)
        assert torch.equal(got, gf_kernel.apply_matrix_packed_plain(table, x))
        assert torch.equal(got, gf_kernel.apply_matrix(table, x))
        host = got.cpu().numpy()
        assert np.array_equal(host, oracle.apply_matrix(mat, data)), (
            mat.shape, data.shape)
        cases += 1
        return host

    for d, p in PACKED_GEOMETRIES:
        enc = matrix.build_encode_matrix(d, p)
        for s in (256, 512, 4096):
            for b in (1, 2, 3):
                data = rng.integers(0, 256, (b, d, s), dtype=np.uint8)
                parity = check(enc[d:], data)
                if p >= 2 and d >= 2:
                    lost = [0, d + p - 1]
                    present = [i for i in range(d + p) if i not in lost][:d]
                    full = np.concatenate([data, parity], axis=1)
                    rebuilt = check(matrix.decode_matrix(enc, present, lost),
                                    np.ascontiguousarray(full[:, present]))
                    assert np.array_equal(rebuilt, full[:, lost])
        ones = np.full((2, d, 512), 0xFF, dtype=np.uint8)
        check(enc[d:], ones)
    # dense decode rows at the main path's geometry, all-0xFF shards
    enc = matrix.build_encode_matrix(D, P)
    present = [i for i in range(D + P) if i not in LOST][:D]
    dec = matrix.decode_matrix(enc, present, list(LOST))
    check(dec, np.full((3, D, 4096), 0xFF, dtype=np.uint8))
    # a base pointer off 16-byte alignment takes the byte path
    data = rng.integers(0, 256, 3 * D * 4096 + 1, dtype=np.uint8)
    buf = torch.from_numpy(data).to(dev)
    check(enc[D:], data[1:].reshape(3, D, 4096), buf[1:].view(3, D, 4096))
    for r, k, s in ((9, 10, 512), (4, 16, 512), (4, 10, 128)):
        table = gf_kernel.to_device_matrix(np.ones((r, k), np.uint8), dev)
        try:
            gf_kernel.apply_matrix_packed(
                table, torch.zeros((1, k, s), dtype=torch.uint8, device=dev))
        except ErasureError:
            continue
        raise AssertionError(f"r={r} k={k} s={s} outside the gate launched")
    torch.cuda.synchronize()
    log(f"gf_apply_packed: {cases} cases equal to its plain version, "
        f"gf_apply and numpy; 3 geometries outside the gate raised")


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


OBJECT_PARTS = 1024   # BASELINE.md config 2: a 10 GiB stream, nothing cut
DISK_PARTS = 100      # the on-disk object: ~1 GiB (config 3's geometry)
TAIL = 777            # bytes of the short last part of each object
OBJECT_BATCH = 256    # bench.py config 2: batch, concurrency batch + 4,
OBJECT_STAGE = 8      # stage 8, a shared batcher on a host pipeline
OBJECT5_PARTS = 128   # config 5: a 10 GiB stream of 80 MiB parts,
OBJECT5_BATCH = 32    # batched as config 2's bytes (2.5 GiB a batch),
OBJECT5_STAGE = 2     # staged a block of cuda:dp2,tp4 at a time
DISK5_PARTS = 13      # the config-5 object on disk: ~1 GiB


#: bytes of the synthetic stream's blob: 16 config-2 parts and a prime
#: number of bytes more.  The length is odd, so a chunk of 1 or 4 MiB
#: (configs 2 and 5) starts at a new offset of the blob for the first
#: BLOB_BYTES chunks of a stream: content addressing finds no duplicate
#: chunk to share
BLOB_BYTES = 16 * D * CHUNK + 4099


class CyclicSource:
    """A seeded synthetic stream: ``total`` bytes cycling through one
    random blob of ``BLOB_BYTES``, served through ``readinto`` (one copy
    into the writer's staging, as a socket or pipe reader would)."""

    def __init__(self, blob: bytes, total: int):
        self.blob = memoryview(blob)
        self.remaining = total
        self.off = 0

    async def read(self, n: int = -1) -> bytes:
        mem = bytearray(min(n if n >= 0 else 1 << 20, self.remaining))
        return bytes(mem[:await self.readinto(memoryview(mem))])

    async def readinto(self, mem) -> int:
        n = min(len(mem), self.remaining, len(self.blob) - self.off)
        mem[:n] = self.blob[self.off:self.off + n]
        self.off = (self.off + n) % len(self.blob)
        self.remaining -= n
        return n


def source_slice(blob: bytes, lo: int, n: int) -> bytes:
    """Bytes [lo, lo + n) of the cyclic stream over ``blob``."""
    out = bytearray()
    while n > 0:
        off = lo % len(blob)
        take = min(n, len(blob) - off)
        out += blob[off:off + take]
        lo += take
        n -= take
    return bytes(out)


def recording_batchers():
    """The two batchers, recording each dispatch's shape ``(B, r, k, S)``
    so a path's kernel launches can be checked against its dispatches."""
    from chunky_bits_tpu_torch.ops.batching import (EncodeHashBatcher,
                                                    ReconstructBatcher)

    class RecordingEncode(EncodeHashBatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.shapes: list[tuple] = []

        def _encode(self, coder, stacked):
            b, k, s = stacked.shape
            self.shapes.append((b, coder.parity, k, s))
            return super()._encode(coder, stacked)

    class RecordingReconstruct(ReconstructBatcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.shapes: list[tuple] = []

        def _run_group(self, key, requests):
            d, _p, _present, wanted, size, _code = key
            self.shapes.append((len(requests), len(wanted), d, size))
            return super()._run_group(key, requests)

    return RecordingEncode, RecordingReconstruct


def walk_blocks(backend, limit: str, b: int, part_bytes: int) -> int:
    """Blocks of the ``cuda`` walk for ``b`` parts of ``part_bytes``
    under the backend's ``limit`` attribute; one for a backend without
    one (the ``torch`` backend of the CPU tests)."""
    cap = getattr(backend, limit, None)
    return -(-b // max(1, cap // part_bytes)) if cap else 1


def expected_gf(backend, shapes, packed: bool) -> dict:
    """Launches of each GF kernel that dispatches of ``shapes`` call for:
    one per block of the walk, on the packed kernel where ``packed`` is on
    and the geometry is inside its gate."""
    from chunky_bits_tpu_torch.ops import gf_kernel

    want = {name: 0 for name in KERNELS}
    for b, r, k, s in shapes:
        blocks = walk_blocks(backend, "max_block_bytes", b, k * s)
        name = ("gf_apply_packed"
                if packed and gf_kernel.packed_geometry_ok(r, k, s)
                else "gf_apply")
        want[name] += blocks
    return want


class DispatchRecorder:
    """Records the shape ``(B, r, k, S)`` of every ``submit_apply`` of a
    mesh backend (the one door of its dispatches: ``apply_matrix``, the
    coder's feed-ahead route and the batchers all pass through it)."""

    def __init__(self, backend):
        self.backend = backend
        self.shapes: list[tuple] = []
        real = backend.submit_apply

        def submit_apply(mat, shards, on_block=None):
            b, k, s = shards.shape
            self.shapes.append((b, mat.shape[0], k, s))
            return real(mat, shards, on_block=on_block)

        backend.submit_apply = submit_apply

    def take(self) -> list[tuple]:
        shapes, self.shapes = self.shapes, []
        return shapes

    def expected(self) -> dict:
        """Launches the recorded dispatches call for, then cleared: each
        block launches one kernel per logical device with work, K2 on
        every ('dp', 'tp') device, K1 on every ('dp', 'sp') one, and one
        reduce-and-pack per 'dp' group of a tp block."""
        want = {name: 0 for name in KERNELS}
        for b, r, k, s in self.take():
            if b == 0 or r == 0 or s == 0:
                continue
            lay, block = self.backend.plan(b, r, k, s)
            for lo in range(0, b, block):
                n = min(block, b - lo)
                name = "gf_acc" if lay.wide else "gf_apply"
                want[name] += min(n, lay.dp) * lay.minor
                if lay.wide:
                    want["gf_acc_pack"] += min(n, lay.dp)
        return want


def object_builder(destination, batcher, pipeline, geo=None,
                   batch: int = OBJECT_BATCH, stage: int = OBJECT_STAGE,
                   backend=None):
    from chunky_bits_tpu_torch.file import FileWriteBuilder

    geo = geo or CONFIG2
    return (FileWriteBuilder().with_backend(backend)
            .with_destination(destination).with_chunk_size(geo.chunk)
            .with_data_chunks(geo.d).with_parity_chunks(geo.p)
            .with_concurrency(batch + 4)
            .with_batch_parts(batch).with_stage_parts(stage)
            .with_encode_batcher(batcher).with_host_pipeline(pipeline))


def phase_object_ingest(blob: bytes, pipeline, label: str, geo=None,
                        parts: int = OBJECT_PARTS,
                        batch: int = OBJECT_BATCH,
                        stage: int = OBJECT_STAGE, backend=None):
    """A stream of ``parts`` full parts plus a 777-byte tail part through
    the port's writer over the void destination; returns the file
    reference and the batcher."""
    import asyncio

    geo = geo or CONFIG2
    encode_cls, _ = recording_batchers()
    total = parts * geo.d * geo.chunk + TAIL

    async def drive():
        batcher = encode_cls(backend=backend, max_batch=batch,
                             host_pipeline=pipeline)
        t0 = time.perf_counter()
        ref = await object_builder(None, batcher, pipeline, geo, batch,
                                   stage, backend).write(
            CyclicSource(blob, total))
        dt = time.perf_counter() - t0
        await batcher.aclose()
        return ref, batcher, dt

    ref, batcher, dt = asyncio.run(drive())
    assert ref.length == total and len(ref.parts) == parts + 1
    sizes = sorted({sh[0] for sh in batcher.shapes})
    log(f"object ingest {label}: {total / 2**30:.3f} GiB through "
        f"FileWriteBuilder (void destination, d={geo.d} p={geo.p}, "
        f"{geo.chunk >> 20} MiB chunks) in {dt:.2f} s, "
        f"{gib_s(total, dt):.2f} GiB/s; {batcher.dispatches} dispatch(es)"
        + (f" of {sizes} parts" if sizes else ""))
    return ref, batcher


def phase_object_ingest_warm(blob: bytes, pipeline) -> None:
    """16 parts through the same builder, outside any counted path: the
    walk's pinned staging and the host threads are allocated here."""
    import asyncio

    from chunky_bits_tpu_torch.ops.batching import EncodeHashBatcher

    async def drive():
        batcher = EncodeHashBatcher(max_batch=OBJECT_BATCH,
                                    host_pipeline=pipeline)
        await object_builder(None, batcher, pipeline).write(
            CyclicSource(blob, 16 * D * CHUNK))
        await batcher.aclose()

    asyncio.run(drive())


def check_object_ref(ref, blob: bytes, geo=None, parts: int = OBJECT_PARTS,
                     sample: int = 4) -> None:
    """A sample of parts, the tail included, against the numpy oracle and
    hashlib."""
    from chunky_bits_tpu_torch.ops import matrix
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    geo = geo or CONFIG2
    rows_of = matrix.build_encode_matrix(geo.d, geo.p)[geo.d:]
    rng = np.random.default_rng(SEED + 5)
    picked = sorted(rng.choice(parts, sample, replace=False).tolist())
    for i in picked + [parts]:
        length = geo.d * geo.chunk if i < parts else TAIL
        shard = -(-length // geo.d)
        raw = np.zeros(geo.d * shard, dtype=np.uint8)
        raw[:length] = np.frombuffer(
            source_slice(blob, i * geo.d * geo.chunk, length),
            dtype=np.uint8)
        data = raw.reshape(1, geo.d, shard)
        parity = NumpyBackend().apply_matrix(rows_of, data)
        rows = np.concatenate([data, parity], axis=1)[0]
        part = ref.parts[i]
        assert part.chunksize == shard
        got = [c.hash.value.digest for c in part.data + part.parity]
        assert got == [hashlib.sha256(r).digest() for r in rows], i
    log(f"object ingest d={geo.d} p={geo.p}: parts {picked} and the tail "
        f"equal to numpy and hashlib")


async def read_and_compare(builder, blob: bytes, total: int) -> None:
    pos = 0
    async for buf in builder.stream():
        n = len(buf)
        assert bytes(buf) == source_slice(blob, pos, n), pos
        pos += n
    assert pos == total, (pos, total)


def phase_round_trip(blob: bytes, pipeline, path, sfx: str, expect,
                     geo=None, parts: int = DISK_PARTS,
                     backend=None) -> dict:
    """An object of ``parts`` parts (and a tail) over d+p ``path``
    destinations: write, read, lose the chunk files of ``geo.lost`` in
    every part, read degraded, verify, resilver, verify and read again.
    Each step is a path of its own for the launch counts; ``expect(b)``
    gives the launches a step's batcher ``b`` called for."""
    import asyncio
    import shutil
    import tempfile

    from chunky_bits_tpu_torch.file import (FileReadBuilder,
                                            LocationsDestination)

    geo = geo or CONFIG2
    encode_cls, reconstruct_cls = recording_batchers()
    total = parts * geo.d * geo.chunk + TAIL
    expected = {}

    def timed(name, coro_fn, nbytes: int):
        t0 = time.perf_counter()
        out = path(name + sfx, lambda: asyncio.run(coro_fn()))
        dt = time.perf_counter() - t0
        log(f"  {name}: {dt:.2f} s, {gib_s(nbytes, dt):.2f} GiB/s")
        return out

    with tempfile.TemporaryDirectory(prefix="cb-smoke-") as root:
        dirs = [os.path.join(root, f"d{i}") for i in range(geo.d + geo.p)]
        for d in dirs:
            os.mkdir(d)
        dest = LocationsDestination(dirs)
        free = shutil.disk_usage(root).free
        label = {"": "packed=False", "_packed": "packed=True"}.get(
            sfx, backend)
        log(f"object round trip {label}: "
            f"{total / 2**30:.3f} GiB over {len(dirs)} path destinations "
            f"under {root} ({free / 2**30:.1f} GiB free before)")

        async def write():
            batcher = encode_cls(backend=backend, max_batch=OBJECT_BATCH,
                                 host_pipeline=pipeline)
            ref = await object_builder(dest, batcher, pipeline, geo,
                                       backend=backend).write(
                CyclicSource(blob, total))
            await batcher.aclose()
            return ref, batcher

        ref, enc = timed("object_write", write, total)
        expected["object_write" + sfx] = expect(enc)

        async def read():
            # a read takes any d of the d+p chunks at random, so a healthy
            # part rebuilds its data rows whenever parity came first
            batcher = reconstruct_cls(backend=backend)
            await read_and_compare(
                FileReadBuilder(ref).with_backend(backend)
                .with_batcher(batcher), blob, total)
            await batcher.aclose()
            return batcher

        rec = timed("object_read", read, total)
        expected["object_read" + sfx] = expect(rec)

        lost = []
        for part in ref.parts:
            chunks = part.data + part.parity
            for i in geo.lost:
                lost.append(str(chunks[i].locations[0]))
                os.remove(lost[-1])

        rec = timed("object_degraded_read", read, total)
        assert rec.dispatches > 0
        expected["object_degraded_read" + sfx] = expect(rec)

        t0 = time.perf_counter()
        report = asyncio.run(ref.verify())
        dt = time.perf_counter() - t0
        missing = sorted(str(loc) for loc, _err
                         in report.unavailable_locations())
        assert missing == sorted(lost), "verify must name the lost chunks"
        assert not report.invalid_locations() and not report.is_ideal()
        log(f"  verify: {dt:.2f} s; {report}; exactly the {len(lost)} "
            f"deleted chunks unavailable")

        async def resilver():
            batcher = reconstruct_cls(backend=backend)
            rep = await ref.resilver(dest, backend=backend, batcher=batcher)
            await batcher.aclose()
            return rep, batcher

        rep, rec = timed("object_resilver", resilver,
                         len(ref.parts) * len(geo.lost) * geo.chunk)
        assert len(rep.new_locations()) == len(lost), str(rep)
        assert not rep.failed_writes(), rep.failed_writes()
        expected["object_resilver" + sfx] = expect(rec)
        clean = asyncio.run(ref.verify())
        assert clean.is_ideal(), str(clean)
        rec = timed("object_read_resilvered", read, total)
        expected["object_read_resilvered" + sfx] = expect(rec)
        log(f"  resilver: {rep}; verify after: {clean}; every read "
            f"byte-identical to the source")
    return expected


#: the cluster_cli group: a pm-msr object of ~256 MiB at BASELINE.md
#: config 13's geometry (d=5 p=4, 1 MiB chunks), and the small object the
#: ``python -m`` entry point copies in a subprocess
PM_MSR = Geometry(5, 4, CHUNK, ())
PM_MSR_PARTS = 51
SMALL_OBJECT = 3 * D * CHUNK + TAIL
#: the cluster_cli group's config-2 object: ~512 MiB, cut from the ~1 GiB
#: of the on-disk round trips for the script's time
CLI_PARTS = DISK_PARTS // 2


class ApplyRecorder:
    """Records the shape ``(B, r, k, S)`` of every ``apply_matrix`` call of
    the ``cuda`` backend (its encode+hash and every decode pass through
    it), so a path's K1 launches can be checked against its dispatches:
    one per block of the walk."""

    def __init__(self, backend):
        self.backend = backend
        self.shapes: list[tuple] = []
        real = backend.apply_matrix

        def apply_matrix(mat, shards, *args, **kwargs):
            b, k, s = shards.shape
            self.shapes.append((b, mat.shape[0], k, s))
            return real(mat, shards, *args, **kwargs)

        backend.apply_matrix = apply_matrix

    def take(self) -> list[tuple]:
        """The recorded shapes that launch (none of B, r, k, S is 0),
        then cleared."""
        shapes, self.shapes = self.shapes, []
        return [sh for sh in shapes if 0 not in sh]

    def expected(self) -> dict:
        """Launches the recorded calls call for, then cleared."""
        return expected_gf(self.backend, self.take(), False)

    def close(self) -> None:
        del self.backend.apply_matrix


def run_cli(argv: list[str], out_path: str) -> bytes:
    """``chunky_bits_tpu_torch.cli.main.main(argv)`` in this process, its
    standard output sent to ``out_path``; returns that output unless it is
    a ``cat``.  Raises unless the command exits 0."""
    import io

    from chunky_bits_tpu_torch.cli.main import main as cli_main

    # an empty config of its own, so no default config file is read
    config = os.path.join(os.path.dirname(out_path), "config.yaml")
    open(config, "a").close()
    saved = sys.stdout
    with open(out_path, "wb") as raw:
        sys.stdout = io.TextIOWrapper(raw, write_through=True)
        try:
            rc = cli_main(["--config", config] + argv)
            sys.stdout.flush()
        finally:
            sys.stdout.detach()
            sys.stdout = saved
    assert rc == 0, (argv, rc)
    if argv[0] == "cat":
        return b""
    with open(out_path, "rb") as f:
        return f.read()


def write_source(path: str, blob: bytes, total: int) -> None:
    """The first ``total`` bytes of the cyclic stream over ``blob``."""
    with open(path, "wb") as f:
        for lo in range(0, total, 64 << 20):
            f.write(source_slice(blob, lo, min(64 << 20, total - lo)))


def same_file(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def cluster_yaml(root: str, geo: Geometry, backend, code: str = "rs",
                 cache_bytes: int = 0, locations=None, slabs: int = 0,
                 meta: str = "path", block: int = 0,
                 scrub_rate: int = 0, extra=None) -> str:
    """A cluster of d+p destinations under ``root`` (the first ``slabs``
    of them ``slab:`` stores, the rest ``path``; or ``locations``), a
    ``meta`` metadata store (``path`` or ``meta-log``) and one profile of
    ``geo``; ``backend`` None leaves it out (the port's default backend),
    ``cache_bytes``, ``block`` (``repair_block_bytes``) and
    ``scrub_rate`` (``scrub_bytes_per_sec``) above 0 set those tunables,
    and ``extra`` adds tunables as given (``slo_eval_s``, ``slo``,
    ``qos``)."""
    import yaml

    dirs = locations
    if dirs is None:
        dirs = [os.path.join(root, f"d{i}") for i in range(geo.d + geo.p)]
        for d in dirs:
            os.makedirs(d)
        dirs = [f"slab:{d}" if i < slabs else d for i, d in enumerate(dirs)]
    os.makedirs(os.path.join(root, "meta"))
    spec = {
        "destinations": [{"location": d} for d in dirs],
        "metadata": {"type": meta, "format": "yaml",
                     "path": os.path.join(root, "meta")},
        "profiles": {"default": {
            "data": geo.d, "parity": geo.p,
            "chunk_size": geo.chunk.bit_length() - 1, "code": code}},
    }
    tunables = {}
    if backend is not None:
        tunables["backend"] = backend
    for key, value in (("cache_bytes", cache_bytes),
                       ("repair_block_bytes", block),
                       ("scrub_bytes_per_sec", scrub_rate)):
        if value:
            tunables[key] = value
    tunables.update(extra or {})
    if tunables:
        spec["tunables"] = tunables
    path = os.path.join(root, "cluster.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(spec, f, sort_keys=False)
    return path


def damage_chunks(meta_file: str, pick) -> list[str]:
    """Delete the chunk file of ``pick(part_no)``'s shards in every part of
    the reference in ``meta_file``; each must be a digest no other chunk
    of the object has (content addressing shares the file of equal
    chunks).  Returns the deleted paths."""
    import yaml

    with open(meta_file) as f:
        ref = yaml.safe_load(f)
    chunks = [c for part in ref["parts"]
              for c in part["data"] + part.get("parity", [])]
    digests = [c["sha256"] for c in chunks]
    lost = []
    for i, part in enumerate(ref["parts"]):
        row = part["data"] + part.get("parity", [])
        for j in pick(i):
            assert digests.count(row[j]["sha256"]) == 1, (i, j)
            lost.append(row[j]["locations"][0])
            os.remove(lost[-1])
    return lost


def check_resilver(report: str, parts: int) -> None:
    """A ``resilver`` full report in which every part's lost chunks were
    rebuilt and written: each part and chunk line reads Valid or
    Resilvered, and no part carries a rebuild error nor a chunk a write
    error (the command exits 0 either way)."""
    lines = report.splitlines()
    assert lines[0] in ("file\tValid", "file\tResilvered"), lines[0]
    heads = [ln for ln in lines if ln.startswith("part\t")]
    assert len(heads) == parts, (len(heads), parts)
    assert all(ln in ("part\tValid", "part\tResilvered") for ln in heads), \
        [ln for ln in heads if ln not in ("part\tValid", "part\tResilvered")]
    assert not [ln for ln in lines if ln.startswith("error\t")], \
        "resilver failed to write a chunk"
    bad = [ln for ln in lines if ln.startswith("chunk\t")
           and ln.split("\t")[1] not in ("Valid", "Resilvered")]
    assert not bad, bad[:4]


def phase_cluster_cli(blob: bytes, path, counts, be, tp_be,
                      tp_rec) -> dict:
    """The cluster_cli group: the port's CLI (``cli.main.main``) in this
    process over cluster YAMLs on the local disk, each step a path of its
    own for the launch counts.  Config 2 with ``backend: cuda``
    (cp, cat, verify, damage, verify, resilver, verify, cat, ls, file-info,
    get-hashes, find-unused-hashes); config 5 with ``backend:
    "jax:dp2,tp4"`` (the JAX package's spelling of the cuda:dp2,tp4 mesh);
    pm-msr at d=5 p=4; then ``python -m chunky_bits_tpu_torch`` cp and cat
    in a subprocess on the default backend.  Each resilver's report must
    show every lost chunk rebuilt and written, and a verify after it must
    read Valid.  A step given ``launches`` must have launched each of
    those kernels, through ``be`` (K1) or ``tp_be`` (K2 and the
    reduce-and-pack) as their recorders show: the cluster ran on the
    card."""
    import json as _json
    import tempfile

    import yaml

    from chunky_bits_tpu_torch.cluster.tunables import (BACKEND_ENV,
                                                        environ_without)
    from chunky_bits_tpu_torch.ops.backend import get_backend

    expected = {}
    rec = ApplyRecorder(be)

    def step(name: str, argv: list[str], out: str, nbytes: int = 0,
             launches: tuple = ()) -> bytes:
        t0 = time.perf_counter()
        text = path(name, run_cli, argv, out)
        dt = time.perf_counter() - t0
        want, mesh = rec.expected(), tp_rec.expected()
        expected[name] = {k: want[k] + mesh[k] for k in KERNELS}
        for k in launches:
            by = mesh if k in ("gf_acc", "gf_acc_pack") else want
            assert counts[name][k] > 0 and by[k] > 0, \
                (name, k, counts[name], want, mesh)
        log(f"  {argv[0]}: {dt:.2f} s"
            + (f", {gib_s(nbytes, dt):.2f} GiB/s" if nbytes else ""))
        return text

    with tempfile.TemporaryDirectory(prefix="cb-cli-") as root:
        # ---- config 2 through the CLI, backend: cuda ----
        top = os.path.join(root, "c2")
        os.makedirs(top)
        conf = cluster_yaml(top, CONFIG2, "cuda")
        total = CLI_PARTS * D * CHUNK + TAIL
        src = os.path.join(root, "src2.bin")
        write_source(src, blob, total)
        out = os.path.join(root, "out")
        txt = os.path.join(root, "stdout.txt")
        obj = f"{conf}#obj"
        log(f"cluster_cli config 2: {total / 2**30:.3f} GiB over "
            f"{D + P} path destinations, backend: cuda")
        k1 = ("gf_apply",)
        step("cli_cp", ["cp", src, obj], txt, total, k1)
        step("cli_cat", ["cat", obj], out, total, k1)
        assert same_file(src, out), "cat differs from the source"
        report = step("cli_verify", ["verify", obj], txt, total).decode()
        assert report.startswith("file\tValid"), report[:200]
        meta_file = os.path.join(top, "meta", "obj")
        lost = damage_chunks(meta_file, lambda _i: LOST)
        report = step("cli_verify_damaged", ["verify", obj], txt).decode()
        assert report.startswith("file\tDegraded"), report[:200]
        assert all(f"Unavailable\t{p}" in report for p in lost), \
            "verify must name every deleted chunk"
        report = step("cli_resilver", ["resilver", obj], txt,
                      len(lost) * CHUNK, k1).decode()
        check_resilver(report, CLI_PARTS + 1)
        report = step("cli_verify_resilvered", ["verify", obj],
                      txt).decode()
        assert report.startswith("file\tValid"), report[:200]
        step("cli_cat_resilvered", ["cat", obj], out, total, k1)
        assert same_file(src, out), "cat after resilver differs"
        with open(meta_file) as f:
            ref = yaml.safe_load(f)
        listed = step("cli_ls", ["ls", f"{conf}#."], txt).decode().split()
        assert listed == [".", "obj"], listed
        info = _json.loads(step("cli_file_info",
                                ["file-info", "--json", obj], txt))
        assert info == ref, "file-info differs from the reference on disk"
        want = [c["sha256"] for part in ref["parts"]
                for c in part["data"] + part["parity"]]
        got = step("cli_get_hashes", ["get-hashes", obj],
                   txt).decode().split()
        assert got == ["sha256-" + h for h in want], "get-hashes differs"
        dirs = [os.path.join(top, f"d{i}") for i in range(D + P)]
        on_disk = {n for d in dirs for n in os.listdir(d)}
        orphans = sorted(on_disk - {"sha256-" + h for h in want})
        unused = step("cli_find_unused_hashes",
                      ["find-unused-hashes", "--grace-seconds", "0",
                       f"{conf}#.", "--"] + dirs, txt).decode().split()
        assert sorted(unused) == orphans, (unused, orphans)
        log(f"  verify named the {len(lost)} deleted chunks; resilver "
            f"restored them; both cats equal the source; ls, file-info and "
            f"get-hashes agree with the reference on disk; "
            f"find-unused-hashes listed {len(orphans)} orphan(s)")
        os.remove(src)

        # ---- config 5 through the JAX package's backend name: it
        # resolves to the registered cuda:dp2,tp4 on 8 logical devices of
        # the card, what CHUNKY_BITS_TORCH_VIRTUAL_DEVICES=8 gives ----
        assert get_backend("jax:dp2,tp4") is tp_be
        assert len(tp_be.devices) == 8, tp_be.devices
        top = os.path.join(root, "c5")
        os.makedirs(top)
        conf = cluster_yaml(top, CONFIG5, "jax:dp2,tp4")
        total = DISK5_PARTS * CONFIG5.d * CONFIG5.chunk + TAIL
        src = os.path.join(root, "src5.bin")
        write_source(src, blob, total)
        obj = f"{conf}#obj"
        log(f"cluster_cli config 5: {total / 2**30:.3f} GiB over "
            f"{CONFIG5.d + CONFIG5.p} path destinations, backend: "
            f"\"jax:dp2,tp4\" -> {tp_be.name} on 8 logical devices")
        tp = ("gf_acc", "gf_acc_pack")
        step("cli5_cp", ["cp", src, obj], txt, total, tp)
        step("cli5_cat", ["cat", obj], out, total, tp)
        assert same_file(src, out), "config-5 cat differs"
        lost = damage_chunks(os.path.join(top, "meta", "obj"),
                             lambda _i: CONFIG5.lost)
        report = step("cli5_resilver", ["resilver", obj], txt,
                      len(lost) * CONFIG5.chunk, tp).decode()
        check_resilver(report, DISK5_PARTS + 1)
        report = step("cli5_verify_resilvered", ["verify", obj],
                      txt).decode()
        assert report.startswith("file\tValid"), report[:200]
        step("cli5_cat_resilvered", ["cat", obj], out, total, tp)
        assert same_file(src, out), "config-5 cat after resilver"
        log(f"  {len(lost)} chunks lost and resilvered (the report shows "
            f"each written, verify after reads Valid); both cats equal "
            f"the source")
        os.remove(src)

        # ---- pm-msr through a profile ----
        geo = PM_MSR
        top = os.path.join(root, "pm")
        os.makedirs(top)
        conf = cluster_yaml(top, geo, "cuda", code="pm-msr")
        total = PM_MSR_PARTS * geo.d * geo.chunk + TAIL
        src = os.path.join(root, "srcpm.bin")
        write_source(src, blob, total)
        obj = f"{conf}#obj"
        log(f"cluster_cli pm-msr: {total / 2**30:.3f} GiB, d={geo.d} "
            f"p={geo.p}, {geo.chunk >> 20} MiB chunks, backend: cuda")
        step("cli_pm_cp", ["cp", src, obj], txt, total, k1)
        step("cli_pm_cat", ["cat", obj], out, total, k1)
        assert same_file(src, out), "pm-msr cat differs"
        with open(os.path.join(top, "meta", "obj")) as f:
            assert all(part["code"] == "pm-msr"
                       for part in yaml.safe_load(f)["parts"])
        n = geo.d + geo.p
        lost = damage_chunks(os.path.join(top, "meta", "obj"),
                             lambda i: (i % n,))
        report = step("cli_pm_resilver", ["resilver", obj], txt,
                      len(lost) * geo.chunk, k1).decode()
        check_resilver(report, PM_MSR_PARTS + 1)
        report = step("cli_pm_verify_resilvered", ["verify", obj],
                      txt).decode()
        assert report.startswith("file\tValid"), report[:200]
        step("cli_pm_cat_resilvered", ["cat", obj], out, total, k1)
        assert same_file(src, out), "pm-msr cat after resilver differs"
        log(f"  one chunk of each of {len(lost)} parts lost and "
            f"resilvered (the report shows each written, verify after "
            f"reads Valid); both cats equal the source")
        os.remove(src)

        # ---- the real entry point, on the default backend ----
        top = os.path.join(root, "small")
        os.makedirs(top)
        conf = cluster_yaml(top, CONFIG2, None)
        src = os.path.join(root, "small.bin")
        write_source(src, blob, SMALL_OBJECT)
        # the default backend: CHUNKY_BITS_TORCH_BACKEND unset; ``-m``
        # finds the package from the checkout's root
        env = environ_without(BACKEND_ENV)
        here = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "chunky_bits_tpu_torch", "--config",
               os.path.join(root, "config.yaml")]
        t0 = time.perf_counter()
        subprocess.run(cmd + ["cp", src, f"{conf}#small"], env=env,
                       cwd=here, check=True, timeout=300)
        got = subprocess.run(cmd + ["cat", f"{conf}#small"], env=env,
                             cwd=here, check=True, timeout=300,
                             capture_output=True).stdout
        with open(src, "rb") as f:
            assert got == f.read(), "python -m cat differs from the source"
        log(f"cluster_cli entry point: python -m chunky_bits_tpu_torch cp "
            f"and cat of {SMALL_OBJECT} bytes on the default backend in "
            f"{time.perf_counter() - t0:.1f} s, byte-identical")
    rec.close()
    return expected


# ---- the gateway group ----

#: BASELINE config 9's shapes (bench.py:1211-1280): d=3 p=2, 64 KiB chunks
#: over 5 path destinations, hot objects of 16 KiB, 256 KiB and 1 MiB, 24
#: cold objects of 256 KiB, and a 2 MiB read cache that holds the hot
#: tier but not the cold one
CONFIG9 = Geometry(3, 2, 1 << 16, ())
CONFIG9_SIZES = {"small": 16 << 10, "med": 256 << 10, "large": 1 << 20}
CONFIG9_COLD, CONFIG9_COLD_BYTES = 24, 256 << 10
CONFIG9_CACHE = 2 << 20
GW_CLIENTS, GW_ROUNDS = 200, 5
#: the config-2 gateway object's read cache, and the http-destination
#: object: 25 parts and a tail (~256 MiB)
GW_CACHE = 64 << 20
HTTP_PARTS = 25


class ServerThread:
    """Runs ``serve(on_ready)`` (a coroutine that serves until cancelled
    and reports its port through ``on_ready``) on an event loop of its
    own thread, so this thread can be the client; ``stop`` cancels it
    and joins the thread."""

    def __init__(self, serve, label: str):
        import threading

        self.port = None
        self.error = None
        ready = threading.Event()

        def on_ready(port: int) -> None:
            self.port = port
            ready.set()

        def run() -> None:
            self.loop = asyncio.new_event_loop()
            self.task = self.loop.create_task(serve(on_ready))
            try:
                self.loop.run_until_complete(self.task)
            except asyncio.CancelledError:
                pass
            except BaseException as err:  # reported by __init__ or stop
                self.error = err
                ready.set()
            finally:
                self.loop.run_until_complete(self.loop.shutdown_asyncgens())
                self.loop.close()

        self.thread = threading.Thread(target=run, name=label, daemon=True)
        self.thread.start()
        assert ready.wait(120), f"{label} never reported its port"
        if self.error is not None:
            raise self.error

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(60)
        assert not self.thread.is_alive(), "server thread did not stop"
        if self.error is not None:
            raise self.error


def http_request(port: int, method: str, path: str, headers=None,
                 body_parts=(), body_len=None):
    """One request over a new connection: ``body_parts`` are sent as
    they come (a streamed body of ``body_len`` bytes).  Returns (status,
    headers, http.client response ready to read)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.putrequest(method, path)
    for key, value in (headers or {}).items():
        conn.putheader(key, value)
    if body_len is not None:
        conn.putheader("Content-Length", str(body_len))
    conn.endheaders()
    for part in body_parts:
        conn.send(part)
    resp = conn.getresponse()
    return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp


def read_and_match(resp, blob: bytes, lo: int, n: int) -> None:
    """Read ``n`` body bytes off ``resp`` and hold them against bytes
    [lo, lo + n) of the cyclic stream over ``blob``."""
    got = 0
    while got < n:
        piece = resp.read(min(8 << 20, n - got))
        assert piece, f"body ended at {got} of {n} bytes"
        assert piece == source_slice(blob, lo + got, len(piece)), \
            f"body differs from the source at byte {lo + got}"
        got += len(piece)
    assert resp.read() == b"", "body longer than Content-Length"
    resp.close()


class MiniConn:
    """A raw keep-alive HTTP/1.1 GET client (bench.py's config-9 client):
    status line, Content-Length bodies, body-less 304s."""

    def __init__(self, port: int):
        self.port = port

    async def open(self):
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)
        return self

    async def get(self, path: str, extra: str = "") -> tuple:
        self.writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                          f"{extra}\r\n".encode())
        await self.writer.drain()
        status = int((await self.reader.readline()).split(b" ", 2)[1])
        length, etag = 0, None
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b""):
                break
            key = line[:line.index(b":")].lower() if b":" in line else b""
            if key == b"content-length":
                length = int(line[15:])
            elif key == b"etag":
                etag = line[5:].strip().decode()
        body = b""
        if status not in (204, 304) and length:
            body = await self.reader.readexactly(length)
        return status, body, etag

    async def close(self) -> None:
        self.writer.close()
        await asyncio.wait_for(self.writer.wait_closed(), timeout=5)


def running(pid: int) -> bool:
    """True while ``pid`` is a process that has not exited (a zombie
    has)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def parse_metrics(port: int) -> dict:
    from chunky_bits_tpu_torch.obs.metrics import parse_exposition

    status, _h, resp = http_request(port, "GET", "/metrics")
    assert status == 200, status
    return parse_exposition(resp.read().decode())


class ChunkNode:
    """A storage node for ``http://`` destinations: GET (with a single
    Range) and HEAD through aiohttp's FileResponse, PUT published by
    rename, DELETE, over a directory.  The counterpart of the test suite's
    node server, served from this process.  ``gets`` counts GET and HEAD
    requests; with ``delay_s`` above 0 each of them first stalls
    ``delay_s`` x uniform(0.75, 1.25) seconds, drawn from a generator
    seeded with ``seed`` (config 8's slow replica)."""

    def __init__(self, root: str, delay_s: float = 0.0, seed: int = 0):
        import random

        self.root = root
        self.delay_s = delay_s
        self.rng = random.Random(seed)
        self.gets = 0

    def file(self, url_path: str) -> str:
        rel = url_path.lstrip("/")
        assert ".." not in rel.split("/"), url_path
        return os.path.join(self.root, rel)

    async def serve(self, on_ready) -> None:
        from aiohttp import web

        async def get(request):
            self.gets += 1
            if self.delay_s > 0:
                await asyncio.sleep(self.delay_s
                                    * self.rng.uniform(0.75, 1.25))
            path = self.file(request.path)
            if not os.path.isfile(path):
                return web.Response(status=404)
            return web.FileResponse(path)

        async def put(request):
            path = self.file(request.path)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.part.{id(request)}"
            with open(tmp, "wb") as f:
                async for piece in request.content.iter_chunked(1 << 20):
                    f.write(piece)
            os.replace(tmp, path)
            return web.Response()

        async def delete(request):
            try:
                os.remove(self.file(request.path))
            except FileNotFoundError:
                return web.Response(status=404)
            return web.Response()

        app = web.Application(client_max_size=64 << 20)
        app.router.add_get("/{key:.*}", get)
        app.router.add_put("/{key:.*}", put)
        app.router.add_delete("/{key:.*}", delete)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        on_ready(site._server.sockets[0].getsockname()[1])
        try:
            await asyncio.Event().wait()
        finally:
            await runner.cleanup()


def phase_gateway(blob: bytes, path, counts, be, tp_rec) -> dict:
    """The gateway group: the port's HTTP gateway serving from the card.
    (1) config 2 through ``serve`` in this process (PUT, GET, HEAD/ETag,
    304, an in-chunk and a cross-part Range, 416, shards 0, 1, 12 and 13
    of every part lost and GET again, /metrics, ``stats``); (2) BASELINE
    config 9's mix, 200 keep-alive clients x 5 rounds, every body held
    against its source; (3) ``http-gateway --workers 2`` in a subprocess
    through a worker's SIGKILL; (4) a config-2 cluster of ``http://``
    destinations on a node served from this process, through cp, cat,
    lost shards, cat, resilver, verify and cat.  Each in-process step is
    a path of its own for the launch counts, checked against the
    ``cuda`` backend's recorded dispatches (K1) and the tp mesh's (K2 and
    the reduce-and-pack, none here)."""
    import signal
    import tempfile

    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.cluster.tunables import (BACKEND_ENV,
                                                        environ_without)
    from chunky_bits_tpu_torch.file.profiler import percentile
    from chunky_bits_tpu_torch.gateway import serve
    from chunky_bits_tpu_torch.utils.yamlio import yaml_load

    expected = {}
    rec = ApplyRecorder(be)
    here = os.path.dirname(os.path.abspath(__file__))

    def step(name: str, fn, *args, nbytes: int = 0, k1: bool = False):
        t0 = time.perf_counter()
        out = path(name, fn, *args)
        dt = time.perf_counter() - t0
        want, mesh = rec.expected(), tp_rec.expected()
        expected[name] = {k: want[k] + mesh[k] for k in KERNELS}
        if k1:
            assert counts[name]["gf_apply"] > 0 and want["gf_apply"] > 0, \
                (name, counts[name], want)
        log(f"  {name}: {dt:.2f} s"
            + (f", {gib_s(nbytes, dt):.2f} GiB/s" if nbytes else "")
            + f", K1 launches {counts[name]['gf_apply']}")
        return out

    def start_gateway(conf: str) -> ServerThread:
        with open(conf) as f:
            cluster = Cluster.from_obj(yaml_load(f.read()))

        def run(on_ready):
            return serve(cluster, "127.0.0.1", 0, on_ready=on_ready)

        server = ServerThread(run, "gateway")
        server.cluster = cluster
        return server

    with tempfile.TemporaryDirectory(prefix="cb-gw-") as root:
        # ---- (1) config 2 through serve(), in this process ----
        top = os.path.join(root, "c2")
        os.makedirs(top)
        conf = cluster_yaml(top, CONFIG2, "cuda", cache_bytes=GW_CACHE)
        total = DISK_PARTS * D * CHUNK + TAIL
        gw = start_gateway(conf)
        port = gw.port
        log(f"gateway config 2: {total / 2**30:.3f} GiB over {D + P} path "
            f"destinations, backend: cuda, cache_bytes "
            f"{GW_CACHE >> 20} MiB, http://127.0.0.1:{port}")

        def put_object():
            parts = (source_slice(blob, lo, min(8 << 20, total - lo))
                     for lo in range(0, total, 8 << 20))
            status, _h, resp = http_request(
                port, "PUT", "/obj", {"Content-Type": "application/x-cb"},
                parts, total)
            resp.read()
            assert status == 200, status

        def get_range(headers, lo, n, want_status):
            status, hdrs, resp = http_request(port, "GET", "/obj", headers)
            assert status == want_status, (status, headers)
            assert int(hdrs["content-length"]) == n, hdrs
            read_and_match(resp, blob, lo, n)
            return hdrs

        step("gw_put", put_object, nbytes=total, k1=True)
        hdrs = step("gw_get", get_range, {}, 0, total, 200, nbytes=total,
                    k1=True)
        assert hdrs["content-type"] == "application/x-cb", hdrs
        etag = hdrs["etag"]

        def head_and_304():
            status, h, resp = http_request(port, "HEAD", "/obj")
            resp.read()
            assert status == 200 and h["etag"] == etag, (status, h)
            assert int(h["content-length"]) == total, h
            status, h, resp = http_request(port, "GET", "/obj",
                                           {"If-None-Match": etag})
            assert status == 304 and resp.read() == b"", status
            assert h["etag"] == etag, h

        step("gw_head_304", head_and_304)
        # inside one data chunk of part 37, and across parts 60 and 61
        lo = DISK_PARTS * 3 // 8 * D * CHUNK + 3 * CHUNK + 12345
        h = step("gw_range_in_chunk", get_range,
                 {"Range": f"bytes={lo}-{lo + 99999}"}, lo, 100000, 206)
        assert h["content-range"] == f"bytes {lo}-{lo + 99999}/{total}", h
        lo = DISK_PARTS * 61 // 100 * D * CHUNK - 3 * CHUNK - 777
        n = 7 * CHUNK
        h = step("gw_range_cross_part", get_range,
                 {"Range": f"bytes={lo}-{lo + n - 1}"}, lo, n, 206)
        assert h["content-range"] == f"bytes {lo}-{lo + n - 1}/{total}", h

        def past_end():
            status, h, resp = http_request(
                port, "GET", "/obj", {"Range": f"bytes={total + 5}-"})
            resp.read()
            assert status == 416, status
            assert h["content-range"] == f"bytes */{total}", h

        step("gw_range_416", past_end)
        lost = damage_chunks(os.path.join(top, "meta", "obj"),
                             lambda _i: LOST)
        step("gw_get_degraded", get_range, {}, 0, total, 200,
             nbytes=total, k1=True)
        log(f"  {len(lost)} chunk files deleted (shards {LOST} of every "
            f"part): the GET rebuilt them, byte-identical")
        fams = step("gw_metrics", parse_metrics, port)
        for name in ("cb_worker_up", "cb_request_total", "cb_build_info",
                     "cb_cache_hits_total", "cb_pipeline_jobs_total"):
            assert name in fams, name
        sources = {s[1]["source"] for s in
                   fams["cb_request_total"]["samples"]}
        assert {"sendfile", "cond", "meta"} <= sources, sources
        out = subprocess.run(
            [sys.executable, "-m", "chunky_bits_tpu_torch", "--config",
             os.devnull, "stats", f"http://127.0.0.1:{port}"], cwd=here,
            env=environ_without(BACKEND_ENV), check=True, timeout=300,
            capture_output=True, text=True).stdout
        assert "requests: n=" in out and "status=ok" in out, out
        log(f"  /metrics parsed ({len(fams)} families, sources "
            f"{sorted(sources)}); `stats` rc 0: "
            f"{out.splitlines()[1] if len(out.splitlines()) > 1 else out}")
        gw.stop()
        del gw
        stamp("gateway config 2")

        # ---- (2) BASELINE config 9's mix, in this process ----
        top = os.path.join(root, "c9")
        os.makedirs(top)
        conf9 = cluster_yaml(top, CONFIG9, "cuda",
                             cache_bytes=CONFIG9_CACHE)
        rng = np.random.default_rng(SEED + 9)
        payloads = {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                    for name, n in CONFIG9_SIZES.items()}
        for i in range(CONFIG9_COLD):
            payloads[f"cold{i}"] = rng.integers(
                0, 256, CONFIG9_COLD_BYTES, dtype=np.uint8).tobytes()
        gw = start_gateway(conf9)
        port = gw.port
        chunk = CONFIG9.chunk

        def put_all():
            for name, data in payloads.items():
                status, _h, resp = http_request(port, "PUT", f"/{name}",
                                                body_parts=(data,),
                                                body_len=len(data))
                resp.read()
                assert status == 200, (name, status)

        step("gw9_put", put_all, k1=True,
             nbytes=sum(len(v) for v in payloads.values()))
        lat: dict = {"full": [], "range": [], "cond": [], "cold": [],
                     "large": []}

        async def mix() -> int:
            warm = await MiniConn(port).open()
            etags = {}
            for name in ("small", "med", "large"):
                status, body, etags[name] = await warm.get(f"/{name}")
                assert status == 200 and body == payloads[name], name
            await warm.close()
            med, small = payloads["med"], payloads["small"]

            async def one_client(ci: int) -> int:
                import random

                done = 0
                crng = random.Random(ci)
                conn = await MiniConn(port).open()
                try:
                    for r_i in range(GW_ROUNDS):
                        t0 = time.perf_counter()
                        status, body, _e = await conn.get("/small")
                        lat["full"].append(time.perf_counter() - t0)
                        assert status == 200 and body == small
                        start = crng.randrange(0, len(med) - chunk)
                        start -= start % chunk
                        t0 = time.perf_counter()
                        status, body, _e = await conn.get(
                            "/med", f"Range: bytes={start}-"
                                    f"{start + chunk - 1}\r\n")
                        lat["range"].append(time.perf_counter() - t0)
                        assert status == 206
                        assert body == med[start:start + chunk]
                        t0 = time.perf_counter()
                        status, body, _e = await conn.get(
                            "/small",
                            f"If-None-Match: {etags['small']}\r\n")
                        lat["cond"].append(time.perf_counter() - t0)
                        assert status == 304 and body == b""
                        name = f"cold{(ci + r_i * 7) % CONFIG9_COLD}"
                        span = min(4096, chunk // 2)
                        start = (chunk - span // 2 if (ci + r_i) % 2
                                 else chunk // 4)
                        t0 = time.perf_counter()
                        status, body, _e = await conn.get(
                            f"/{name}", f"Range: bytes={start}-"
                                        f"{start + span - 1}\r\n")
                        lat["cold"].append(time.perf_counter() - t0)
                        assert status == 206
                        assert body == payloads[name][start:start + span]
                        done += 4
                        if ci % 8 == 0:
                            t0 = time.perf_counter()
                            status, body, _e = await conn.get("/large")
                            lat["large"].append(time.perf_counter() - t0)
                            assert status == 200
                            assert body == payloads["large"]
                            done += 1
                finally:
                    await conn.close()
                return done

            return sum(await asyncio.gather(
                *[one_client(i) for i in range(GW_CLIENTS)]))

        def run_mix():
            # the server's read cache is made at its first GET, here
            t0 = time.perf_counter()
            n = asyncio.run(mix())
            wall = time.perf_counter() - t0
            caches = list(gw.cluster._chunk_caches.values())
            return (n, wall, sum(c.hits for c in caches),
                    sum(c.misses for c in caches))

        n, wall, hits, misses = step("gw9_mix", run_mix, k1=True)
        every = sorted(v for vs in lat.values() for v in vs)
        assert len(every) == n
        log(f"  config 9 mix: {GW_CLIENTS} keep-alive clients x "
            f"{GW_ROUNDS} rounds, {n} requests in {wall:.2f} s = "
            f"{n / wall:.0f} requests/s, p50 "
            f"{percentile(every, 50) * 1e3:.2f} ms, p99 "
            f"{percentile(every, 99) * 1e3:.2f} ms; cache hit share "
            f"{hits / max(hits + misses, 1):.3f} ({hits} hits, {misses} "
            f"misses); every body equal to its source")
        for kind in ("full", "range", "cond", "cold", "large"):
            vals = sorted(lat[kind])
            log(f"    {kind}: n={len(vals)} p50 "
                f"{percentile(vals, 50) * 1e3:.2f} ms p99 "
                f"{percentile(vals, 99) * 1e3:.2f} ms")
        gw.stop()
        del gw
        stamp("gateway config 9 mix")

        # ---- (3) two workers through the CLI, in a subprocess ----
        top = os.path.join(root, "fleet")
        os.makedirs(top)
        conf_f = cluster_yaml(top, CONFIG9, "cuda",
                              cache_bytes=CONFIG9_CACHE)
        t0 = time.perf_counter()
        sup = subprocess.Popen(
            [sys.executable, "-m", "chunky_bits_tpu_torch", "--config",
             os.devnull, "http-gateway", conf_f, "-l", "127.0.0.1:0",
             "--workers", "2"], cwd=here, stdout=subprocess.PIPE,
            text=True)
        try:
            line = sup.stdout.readline()
            m = re.search(r"http://127\.0\.0\.1:(\d+) \(2 workers\)", line)
            assert m, f"supervisor said {line!r}"
            port = int(m.group(1))
            deadline = time.time() + 120
            pids = []
            while time.time() < deadline:
                fam = parse_metrics(port).get("cb_worker_up")
                pids = sorted({int(s[1]["worker"])
                               for s in (fam or {"samples": []})["samples"]})
                if len(pids) == 2:
                    break
                time.sleep(0.5)
            assert len(pids) == 2, pids
            log(f"gateway --workers 2: up with workers {pids} in "
                f"{time.perf_counter() - t0:.1f} s")
            names = ("small", "med", "large", "cold0")
            for name in names:
                status, _h, resp = http_request(
                    port, "PUT", f"/{name}", body_parts=(payloads[name],),
                    body_len=len(payloads[name]))
                resp.read()
                assert status == 200, (name, status)
            for _ in range(3):
                for name in names:
                    status, _h, resp = http_request(port, "GET", f"/{name}")
                    assert status == 200 and resp.read() == payloads[name]
            os.kill(pids[0], signal.SIGKILL)
            served = 0
            for _ in range(100):
                try:
                    status, _h, resp = http_request(port, "GET", "/med")
                    if status == 200:
                        assert resp.read() == payloads["med"]
                        served += 1
                except (ConnectionError, OSError):
                    pass
                if served >= 20:
                    break
            assert served >= 20, served
            log(f"  worker {pids[0]} SIGKILLed: {served} GETs answered "
                f"byte-identical after it")
        finally:
            sup.send_signal(signal.SIGINT)
            rc = sup.wait(timeout=60)
            sup.stdout.close()
        assert rc == 0, rc
        deadline = time.time() + 30
        while time.time() < deadline and any(map(running, pids)):
            time.sleep(0.2)
        assert not any(map(running, pids)), pids
        log(f"  SIGINT: the supervisor exited rc 0 and every worker with "
            f"it, {time.perf_counter() - t0:.1f} s in all")
        stamp("gateway workers")

        # ---- (4) http:// destinations on a node in this process ----
        node = ChunkNode(os.path.join(root, "node"))
        node_server = ServerThread(node.serve, "chunk node")
        try:
            base = f"http://127.0.0.1:{node_server.port}"
            top = os.path.join(root, "h2")
            os.makedirs(top)
            conf = cluster_yaml(top, CONFIG2, "cuda", locations=[
                f"{base}/d{i}/" for i in range(D + P)])
            total = HTTP_PARTS * D * CHUNK + TAIL
            src = os.path.join(root, "srch.bin")
            write_source(src, blob, total)
            out = os.path.join(root, "out")
            txt = os.path.join(root, "stdout.txt")
            obj = f"{conf}#obj"
            log(f"gateway http destinations: {total / 2**30:.3f} GiB over "
                f"{D + P} http://127.0.0.1 destinations, backend: cuda")
            step("http_cp", run_cli, ["cp", src, obj], txt, nbytes=total,
                 k1=True)
            step("http_cat", run_cli, ["cat", obj], out, nbytes=total,
                 k1=True)
            assert same_file(src, out), "http cat differs"
            with open(os.path.join(top, "meta", "obj")) as f:
                ref = yaml_load(f.read())
            lost = []
            digests = [c["sha256"] for part in ref["parts"]
                       for c in part["data"] + part["parity"]]
            for part in ref["parts"]:
                row = part["data"] + part["parity"]
                for j in LOST:
                    assert digests.count(row[j]["sha256"]) == 1
                    url = row[j]["locations"][0]
                    assert url.startswith(base), url
                    os.remove(node.file(url[len(base):]))
                    lost.append(url)
            step("http_cat_degraded", run_cli, ["cat", obj], out,
                 nbytes=total, k1=True)
            assert same_file(src, out), "degraded http cat differs"
            report = step("http_resilver", run_cli, ["resilver", obj], txt,
                          nbytes=len(lost) * CHUNK, k1=True).decode()
            check_resilver(report, HTTP_PARTS + 1)
            report = step("http_verify", run_cli, ["verify", obj],
                          txt).decode()
            assert report.startswith("file\tValid"), report[:200]
            step("http_cat_resilvered", run_cli, ["cat", obj], out,
                 nbytes=total, k1=True)
            assert same_file(src, out), "http cat after resilver differs"
            log(f"  {len(lost)} chunks deleted on the node, rebuilt by "
                f"the degraded cat and resilvered (verify Valid); every "
                f"cat equals the source")
        finally:
            node_server.stop()
        stamp("gateway http destinations")
    rec.close()
    return expected


# ---- the storage group ----

#: BASELINE config 11 (bench.py:2136ff): 200 objects of 3 x 64 KiB, d=3
#: p=2, 64 KiB chunks, 4 KiB digest blocks, 3 slab: + 2 path destinations,
#: one flipped byte in one chunk replica of 40 objects
CONFIG11 = Geometry(3, 2, 1 << 16, ())
C11_OBJECTS, C11_CORRUPT, BLOCK = 200, 40, 4096
#: BASELINE config 13: 120 objects of 5 x 16 KiB, d=5 p=4, 9 path nodes,
#: 30 objects lose the only replica of one data chunk
CONFIG13 = Geometry(5, 4, 1 << 14, ())
C13_OBJECTS, C13_LOST = 120, 30
#: config 2 on disk: parts whose chunk gets one flipped byte, then parts
#: that lose the only replica of a whole chunk
C2_FLIPPED, C2_DROPPED = 20, 10
#: the gateway's scrub rate: far above what one pass reads, so the pass
#: is not throttled
GW_SCRUB_RATE = 1 << 30
#: the storage group's config-2 object: ~512 MiB, cut from the ~1 GiB of
#: the other groups' on-disk objects for the script's time; it holds more
#: parts than the 30 the damage step touches
ST_PARTS = DISK_PARTS // 2


def flip_replica(location, offset: int) -> None:
    """One flipped byte at chunk offset ``offset`` of a path or slab
    replica."""
    if location.is_slab():
        path, base, _n = location.slab_extent()
    else:
        path, base = location.target, 0
    with open(path, "r+b") as f:
        f.seek(base + offset)
        byte = f.read(1)
        f.seek(base + offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def drop_replica(location) -> None:
    """The replica gone: its file removed, or its extent marked dead."""
    if location.is_slab():
        asyncio.run(location.delete())
    else:
        os.remove(location.target)


def unique_chunk(ref, part_no: int, start: int):
    """The first chunk of part ``part_no`` from index ``start`` on (cyclic)
    whose digest no other chunk of the object shares."""
    digests = [str(c.hash) for part in ref.parts
               for c in part.data + part.parity]
    row = ref.parts[part_no].data + ref.parts[part_no].parity
    for j in range(len(row)):
        chunk = row[(start + j) % len(row)]
        if digests.count(str(chunk.hash)) == 1:
            return chunk
    raise AssertionError(f"part {part_no} has no chunk of its own")


class ScrubCapture:
    """Keeps the stats of every ``ScrubDaemon.run_once`` while open (the
    CLI prints only the one-line summary)."""

    def __init__(self):
        from chunky_bits_tpu_torch.cluster import scrub

        self.mod, self.real, self.stats = scrub, scrub.ScrubDaemon.run_once, []

        async def run_once(daemon):
            out = await self.real(daemon)
            self.stats.append(out)
            return out

        scrub.ScrubDaemon.run_once = run_once

    def close(self) -> None:
        self.mod.ScrubDaemon.run_once = self.real


class FusedCount:
    """Counts the native fused read+hash passes (``cpu_backend.
    sha256_file``, which ``file_part._hash_local_fused`` calls) while
    open."""

    def __init__(self):
        from chunky_bits_tpu_torch.ops import cpu_backend

        self.mod, self.real, self.calls = cpu_backend, \
            cpu_backend.sha256_file, 0

        def sha256_file(*args):
            self.calls += 1
            return self.real(*args)

        cpu_backend.sha256_file = sha256_file

    def take(self) -> int:
        calls, self.calls = self.calls, 0
        return calls

    def close(self) -> None:
        self.mod.sha256_file = self.real


def phase_storage(blob: bytes, path, counts, be, tp_rec) -> tuple:
    """The storage group: slab destinations, meta-log metadata, scrub and
    the repair planner on the card.  (1) config 2 through the CLI in this
    process over 7 ``slab:`` + 7 ``path`` destinations: cp, 20 flipped
    bytes and 10 lost chunks, ``scrub --once``, verify, cat, meta-compact,
    ls, find-unused-hashes; (2) config 11, one planner pass with a
    profiler; (3) config 13's rs and pm-msr legs; (4) config 11's cluster
    served by ``gateway.serve`` with the scrub daemon on.  Each step is a
    path; its K1 launches are held against the ``cuda`` backend's
    recorded dispatches and must be nonzero on every repair step.
    Returns (expected launches, the decode shapes the planner dispatched
    and how often)."""
    import collections
    import tempfile

    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.cluster.meta_log import MetaLogStore
    from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon
    from chunky_bits_tpu_torch.file.profiler import new_profiler
    from chunky_bits_tpu_torch.gateway import serve
    from chunky_bits_tpu_torch.obs.metrics import parse_exposition
    from chunky_bits_tpu_torch.utils import aio
    from chunky_bits_tpu_torch.utils.yamlio import yaml_load

    expected = {}
    shapes_seen: collections.Counter = collections.Counter()
    rec = ApplyRecorder(be)
    capture = ScrubCapture()

    def step(name: str, fn, *args, nbytes: int = 0, k1: bool = False,
             repair: bool = False):
        rec.expected(), tp_rec.expected()  # work between steps: not this one
        t0 = time.perf_counter()
        out = path(name, fn, *args)
        dt = time.perf_counter() - t0
        shapes = list(rec.shapes)
        want, mesh = rec.expected(), tp_rec.expected()
        expected[name] = {k: want[k] + mesh[k] for k in KERNELS}
        if k1:
            assert counts[name]["gf_apply"] > 0 and want["gf_apply"] > 0, \
                (name, counts[name], want)
        if repair:
            shapes_seen.update(shapes)
        log(f"  {name}: {dt:.2f} s"
            + (f", {gib_s(nbytes, dt):.2f} GiB/s" if nbytes else "")
            + f", K1 launches {counts[name]['gf_apply']}")
        return out, dt, shapes

    def cluster_of(conf: str):
        with open(conf) as f:
            return Cluster.from_obj(yaml_load(f.read()))

    def ref_in(top: str, name: str):
        from chunky_bits_tpu_torch.file.file_reference import FileReference

        store = MetaLogStore(os.path.join(top, "meta"))
        return FileReference.from_obj(yaml_load(store.read_bytes(name)))

    def plans_per_launch(stats, shapes) -> str:
        rep = stats.repair
        plans = rep["plans_decode"] + rep["plans_msr"]
        return (f"{plans} plans in {len(shapes)} dispatches "
                f"({plans / max(len(shapes), 1):.2f} plans a dispatch; "
                f"shapes {dict(collections.Counter(shapes))})")

    with tempfile.TemporaryDirectory(prefix="cb-st-") as root:
        # ---- (1) config 2 through the CLI, slab + path, meta-log ----
        top = os.path.join(root, "c2")
        os.makedirs(top)
        conf = cluster_yaml(top, CONFIG2, "cuda", slabs=7, meta="meta-log",
                            block=BLOCK)
        total = ST_PARTS * D * CHUNK + TAIL
        src = os.path.join(root, "src2.bin")
        write_source(src, blob, total)
        out = os.path.join(root, "out")
        txt = os.path.join(root, "stdout.txt")
        obj = f"{conf}#obj"
        log(f"storage config 2: {total / 2**30:.3f} GiB over 7 slab: + 7 "
            f"path destinations, meta-log metadata, 4 KiB digest blocks, "
            f"backend: cuda")
        step("st_cp", run_cli, ["cp", src, obj], txt, nbytes=total, k1=True)
        ref = ref_in(top, "obj")
        for i in range(C2_FLIPPED):
            flip_replica(unique_chunk(ref, i, i).locations[0],
                         BLOCK * (7 * i % (CHUNK // BLOCK)) + 123 + i)
        for i in range(C2_FLIPPED, C2_FLIPPED + C2_DROPPED):
            drop_replica(unique_chunk(ref, i, i).locations[0])
        replica_bytes = (ST_PARTS * (D + P) * CHUNK
                         + (D + P) * -(-TAIL // D))
        replicas = (ST_PARTS + 1) * (D + P)
        fused = FusedCount()
        (text, dt, shapes) = step("st_scrub", run_cli,
                                  ["scrub", "--once", conf], txt,
                                  nbytes=replica_bytes, k1=True,
                                  repair=True)
        stats = capture.stats.pop()
        rep = stats.repair
        # every replica left is hashed by the native fused read+hash, and
        # the planner re-reads each corrupt chunk to localize its damage,
        # as the JAX package's planner does for the same damage
        scrub_fused = fused.take()
        assert scrub_fused == replicas - C2_DROPPED, scrub_fused
        assert rep["bytes_localized"] == C2_FLIPPED * CHUNK, rep
        log(f"  {text.decode().strip()}")
        assert (stats.corrupt, stats.unavailable, stats.repair_failures) \
            == (C2_FLIPPED, C2_DROPPED, 0), stats
        assert stats.repaired == C2_FLIPPED + C2_DROPPED, stats
        assert (rep["plans_decode"], rep["plans_fallback"]) == \
            (C2_FLIPPED + C2_DROPPED, 0), rep
        assert rep["helper_bytes_decode"] == \
            C2_FLIPPED * D * BLOCK + C2_DROPPED * D * CHUNK, rep
        assert stats.bytes_verified == replica_bytes - C2_DROPPED * CHUNK
        log(f"  scrub: {stats.bytes_verified / 2**30:.3f} GiB verified at "
            f"{gib_s(stats.bytes_verified, dt):.2f} GiB/s; repair "
            f"{rep['helper_bytes_decode']} helper bytes for "
            f"{rep['bytes_rebuilt']} rebuilt "
            f"({rep['helper_bytes_per_rebuilt_byte']} a byte); "
            f"{plans_per_launch(stats, shapes)}; {scrub_fused} replicas "
            f"hashed by the native fused read+hash, "
            f"{rep['bytes_localized']} bytes localized")
        report = step("st_verify", run_cli, ["verify", obj], txt,
                      nbytes=total)[0].decode()
        assert report.startswith("file\tValid"), report[:200]
        assert "Invalid" not in report and "Unavailable" not in report
        verify_fused = fused.take()
        fused.close()
        assert verify_fused == replicas, verify_fused
        log(f"  verify: all {verify_fused} replicas through the native "
            f"fused read+hash")
        step("st_cat", run_cli, ["cat", obj], out, nbytes=total, k1=True)
        assert same_file(src, out), "cat after scrub differs"
        compact = json.loads(step("st_meta_compact", run_cli,
                                  ["meta-compact", conf], txt)[0])
        assert compact["live_refs"] == 1, compact
        listed = step("st_ls", run_cli, ["ls", "-r", f"{conf}#."],
                      txt)[0].decode().split()
        assert listed == [".", "obj"], listed
        roots = [f"slab:{top}/d{i}" for i in range(7)] + \
            [f"{top}/d{i}" for i in range(7, D + P)]
        unused = step("st_find_unused_hashes", run_cli,
                      ["find-unused-hashes", "--grace-seconds", "0",
                       f"{conf}#.", "--"] + roots, txt)[0].decode().split()
        assert unused == [], unused[:4]
        log(f"  verify Valid, cat equal to the source, meta-compact "
            f"{compact}, ls through the meta-log, find-unused-hashes "
            f"listed no live chunk")
        os.remove(src)
        stamp("storage config 2")

        # ---- (2) config 11: one planner pass with a profiler ----
        top = os.path.join(root, "c11")
        os.makedirs(top)
        conf11 = cluster_yaml(top, CONFIG11, "cuda", slabs=3,
                              meta="meta-log", block=BLOCK)
        cluster = cluster_of(conf11)
        rng = np.random.default_rng(SEED + 11)
        payloads = [rng.integers(0, 256, 3 * CONFIG11.chunk,
                                 dtype=np.uint8).tobytes()
                    for _ in range(C11_OBJECTS)]
        picks = np.random.default_rng(SEED + 12)
        victims = sorted(picks.choice(C11_OBJECTS, C11_CORRUPT,
                                      replace=False).tolist())

        async def write_all(cluster, names_payloads):
            profile = cluster.get_profile()
            for name, data in names_payloads:
                await cluster.write_file(name, aio.BytesReader(data),
                                         profile)

        async def read_all(cluster, names_payloads):
            for name, data in names_payloads:
                got = await cluster.file_read_builder(
                    await cluster.get_file_ref(name)).read_all()
                assert got == data, f"{name} differs from its source"

        objs11 = [(f"o{i:04d}", data) for i, data in enumerate(payloads)]
        step("st11_write", lambda: asyncio.run(write_all(cluster, objs11)),
             nbytes=C11_OBJECTS * 3 * CONFIG11.chunk, k1=True)

        def damage11(seed: int) -> None:
            pick = np.random.default_rng(seed)
            for i in victims:
                ref = asyncio.run(cluster.get_file_ref(objs11[i][0]))
                chunk = ref.parts[0].data[int(pick.integers(3))]
                flip_replica(chunk.locations[0],
                             int(pick.integers(CONFIG11.chunk)))

        damage11(SEED + 13)
        profiler, _reporter = new_profiler()
        daemon = ScrubDaemon(cluster, bytes_per_sec=0, profiler=profiler)
        stats, dt, shapes = step("st11_scrub",
                                 lambda: asyncio.run(daemon.run_once()),
                                 k1=True, repair=True)
        rep = stats.repair
        assert (stats.corrupt, stats.repaired, stats.repair_failures) == \
            (C11_CORRUPT, C11_CORRUPT, 0), stats
        assert (rep["plans_decode"], rep["plans_fallback"]) == \
            (C11_CORRUPT, 0), rep
        assert rep["helper_bytes_decode"] == C11_CORRUPT * 3 * BLOCK, rep
        asyncio.run(read_all(cluster, objs11))
        log(f"  config 11: {C11_CORRUPT} decode plans, "
            f"{rep['helper_bytes_decode'] >> 10} KiB of helper reads, "
            f"pass {dt:.2f} s, K1 launches "
            f"{counts['st11_scrub']['gf_apply']}; "
            f"{plans_per_launch(stats, shapes)}; all {C11_OBJECTS} objects "
            f"equal their sources")
        stamp("storage config 11")

        # ---- (3) config 13: the rs and pm-msr legs ----
        for code in ("rs", "pm-msr"):
            top = os.path.join(root, f"c13-{code}")
            os.makedirs(top)
            conf13 = cluster_yaml(top, CONFIG13, "cuda", code=code,
                                  meta="meta-log")
            c13 = cluster_of(conf13)
            rng = np.random.default_rng(SEED + 13)
            objs13 = [(f"o{i:04d}", rng.integers(
                0, 256, CONFIG13.d * CONFIG13.chunk,
                dtype=np.uint8).tobytes()) for i in range(C13_OBJECTS)]
            tag = "pm" if code == "pm-msr" else "rs"
            step(f"st13_{tag}_write",
                 lambda: asyncio.run(write_all(c13, objs13)),
                 nbytes=C13_OBJECTS * CONFIG13.d * CONFIG13.chunk, k1=True)
            for i in range(C13_LOST):
                ref = asyncio.run(c13.get_file_ref(objs13[i][0]))
                drop_replica(ref.parts[0].data[i % CONFIG13.d].locations[0])
            daemon = ScrubDaemon(c13, bytes_per_sec=0,
                                 profiler=new_profiler()[0])
            stats, dt, shapes = step(
                f"st13_{tag}_scrub", lambda: asyncio.run(daemon.run_once()),
                k1=True, repair=True)
            rep = stats.repair
            assert (stats.unavailable, stats.repaired,
                    stats.repair_failures) == (C13_LOST, C13_LOST, 0), stats
            if code == "rs":
                assert rep["plans_decode"] == C13_LOST, rep
                assert rep["helper_bytes_decode"] == \
                    C13_LOST * CONFIG13.d * CONFIG13.chunk, rep
                helper = rep["helper_bytes_decode"]
            else:
                assert (rep["plans_msr"], rep["plans_decode"]) == \
                    (C13_LOST, 0), rep
                beta = CONFIG13.chunk // (CONFIG13.d - 1)
                assert rep["helper_bytes_msr"] == \
                    C13_LOST * 2 * (CONFIG13.d - 1) * beta, rep
                helper = rep["helper_bytes_msr"]
            assert rep["plans_fallback"] == 0, rep
            asyncio.run(read_all(c13, objs13))
            log(f"  config 13 {code}: {helper >> 10} KiB of helper bytes "
                f"for {rep['bytes_rebuilt'] >> 10} KiB rebuilt, pass "
                f"{dt:.2f} s, K1 launches "
                f"{counts[f'st13_{tag}_scrub']['gf_apply']}; "
                f"{plans_per_launch(stats, shapes)}; all objects equal "
                f"their sources")
        stamp("storage config 13")

        # ---- (4) config 11's cluster served with the scrub daemon on ----
        with open(conf11) as f:
            spec = yaml_load(f.read())
        spec["tunables"]["scrub_bytes_per_sec"] = GW_SCRUB_RATE
        gw_cluster = Cluster.from_obj(spec)
        cluster = gw_cluster
        damage11(SEED + 14)

        def serve_and_wait():
            server = ServerThread(
                lambda on_ready: serve(gw_cluster, "127.0.0.1", 0,
                                       on_ready=on_ready), "gateway")
            try:
                deadline = time.time() + 120
                while True:
                    status, _h, resp = http_request(server.port, "GET",
                                                    "/scrub/status")
                    body = json.loads(resp.read())
                    assert status == 200 and body["enabled"] is True, body
                    if body["passes"] >= 1:
                        break
                    assert time.time() < deadline, body
                    time.sleep(0.1)
                name, data = objs11[victims[0]]
                status, _h, resp = http_request(server.port, "GET",
                                                f"/{name}")
                assert status == 200 and resp.read() == data
                metrics = parse_metrics(server.port)
                for fam in ("cb_scrub_passes_total",
                            "cb_scrub_repaired_total",
                            "cb_repair_plans_total",
                            "cb_repair_helper_bytes_total"):
                    assert fam in metrics, fam
                return body
            finally:
                server.stop()

        body, dt, shapes = step("st_gw_scrub", serve_and_wait, k1=True,
                                repair=True)
        assert (body["corrupt"], body["repaired"], body["repair_failures"],
                body["running"]) == (C11_CORRUPT, C11_CORRUPT, 0, True), body
        assert body["repair"]["plans_decode"] == C11_CORRUPT, body
        asyncio.run(read_all(gw_cluster, objs11))
        log(f"  gateway: /scrub/status enabled, first pass "
            f"{body['last_pass_seconds']} s repaired {body['repaired']} "
            f"replicas with {body['repair']['plans_decode']} decode plans; "
            f"a GET of a repaired object equals its source; cb_scrub_* and "
            f"cb_repair_* parse")
    capture.close()
    rec.close()
    return expected, shapes_seen


#: the host_codec group: a cut of config 2's stream for the native and
#: numpy references, and the CLI object of the ``native:4`` YAML
HC_CUT_PARTS = 16
#: the native row hasher's config-2 ingest, cut from 10 GiB to ~1 GiB: the
#: object phases ingest 10 GiB twice already, and the run's time limit
#: needs the seconds
HC_INGEST_PARTS = DISK_PARTS
HC_CLI_PARTS = 25
#: BASELINE.md config 12's grid (bench.py config 12), each cell's working
#: set cut to 16 MiB (bench.py: 64 MiB), best of 3
C12_GEOMETRIES = ((3, 2), (10, 4), (20, 6))
C12_SIZES = (64 << 10, 1 << 20, 4 << 20)
C12_WORKING_SET = 16 << 20
#: the numpy oracle checks the first parts of each config-12 cell
C12_ORACLE_PARTS = 2


def cpu_flags() -> dict:
    """The host CPU's model and the SIMD/SHA flags the codec dispatches
    on, from ``/proc/cpuinfo``."""
    model, flags = "unknown", set()
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _sep, value = line.partition(":")
            if key.strip() == "model name" and model == "unknown":
                model = value.strip()
            elif key.strip() == "flags" and not flags:
                flags = set(value.split())
    return {"model": model, **{k: k in flags
                               for k in ("sha_ni", "gfni", "avx2",
                                         "avx512f")}}


def phase_host_codec(blob: bytes, path, counts, be) -> dict:
    """The host_codec group: the port's native host codec (``csrc/
    gf256.cpp``, built by g++) on the card's box.  (1) the build, its
    tiers and the CPU's flags; ``row_hasher()`` must be the native engine.
    (2) BASELINE.md config 2's void ingest, cut to ~1 GiB, on ``cuda`` (K1
    on the card, SHA-NI on the host, through the shared host pipeline), its
    references equal to a ``native`` and a ``numpy`` run on a cut of the
    same stream.  (3) cp, cat and verify through the CLI on a config-2
    YAML with ``backend: native:4``, the reference equal to the one the
    ``cuda`` YAML writes.  (4) config 12's grid on ``native``: the table
    kernels (best tier and scalar) and the scheduled-XOR engine, each
    cell byte-identical to numpy.  The storage group's config-2 scrub and
    verify ran through the native fused read+hash (checked there).
    Returns the expected launches of its paths."""
    import tempfile

    import yaml

    from chunky_bits_tpu_torch.ops import _build, cpu_backend, matrix
    from chunky_bits_tpu_torch.ops.backend import (NumpyBackend,
                                                   row_hasher_engine)
    from chunky_bits_tpu_torch.parallel.host_pipeline import \
        get_host_pipeline

    expected = {}
    rec = ApplyRecorder(be)

    # ---- (1) the build ----
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.splitlines()[0]
    assert row_hasher_engine() == "native", row_hasher_engine()
    tiers = cpu_backend.native_tiers()
    log(f"host codec: {gxx}; built in "
        f"{_build.HOST_BUILD['seconds'] or 0:.2f} s with "
        f"{_build.HOST_BUILD['flags'] or '(cached)'}; "
        f"sha256_is_accelerated {cpu_backend.sha256_is_accelerated()}; "
        f"tiers gf {tiers['gf']} (0 scalar, 1 AVX2, 2 GFNI), xor "
        f"{tiers['xor']} (0 scalar, 1 SSE2, 2 AVX2); host CPU "
        f"{cpu_flags()}; row hasher {row_hasher_engine()}")

    # ---- (2) config 2's ingest with the native row hasher ----
    pipe = get_host_pipeline()

    def hash_busy() -> tuple:
        st = {x.stage: x for x in pipe.stats().stages}
        h = st.get("hash")
        return (h.busy_s, h.nbytes) if h is not None else (0.0, 0)

    busy0 = hash_busy()
    t0 = time.perf_counter()
    full, batcher = path("hc_ingest", phase_object_ingest, blob, pipe,
                         "cuda, native row hasher", None, HC_INGEST_PARTS)
    dt = time.perf_counter() - t0
    expected["hc_ingest"] = expected_gf(be, batcher.shapes, False)
    busy1 = hash_busy()
    hashed = busy1[1] - busy0[1]
    log(f"  host pipeline: {busy1[0] - busy0[0]:.2f} hash busy s for "
        f"{hashed / 2**30:.2f} GiB hashed ({pipe.threads} workers); "
        f"{full.length / 2**30 / dt:.2f} GiB/s end to end (the hashlib "
        f"row hasher: 0.79-0.80 GiB/s on this phase, PERF.md §5)")
    assert hashed >= full.length, (hashed, full.length)
    want = full.to_obj()["parts"][:HC_CUT_PARTS]
    for name in ("native", "numpy"):
        tag = f"hc_ingest_cut_{name}"
        cut, _b = path(tag, phase_object_ingest, blob, pipe,
                       f"{name}, a cut", None, HC_CUT_PARTS, OBJECT_BATCH,
                       OBJECT_STAGE, name)
        expected[tag] = {k: 0 for k in KERNELS}
        assert cut.to_obj()["parts"][:HC_CUT_PARTS] == want, name
    log(f"  the first {HC_CUT_PARTS} parts' references equal on cuda, "
        f"native and numpy")
    del full
    stamp("host_codec ingest")

    # ---- (3) the CLI on a native:4 YAML ----
    with tempfile.TemporaryDirectory(prefix="cb-hc-") as root:
        total = HC_CLI_PARTS * D * CHUNK + TAIL
        src = os.path.join(root, "src.bin")
        write_source(src, blob, total)
        txt = os.path.join(root, "stdout.txt")
        out = os.path.join(root, "out.bin")
        confs = {}
        for name in ("native:4", "cuda"):
            top = os.path.join(root, name.replace(":", "-"))
            os.makedirs(top)
            confs[name] = cluster_yaml(top, CONFIG2, name)

        def step(tag: str, argv: list[str], dst: str, nbytes: int):
            rec.expected()  # work before the step is not the step's
            t0 = time.perf_counter()
            text = path(tag, run_cli, argv, dst)
            dt = time.perf_counter() - t0
            expected[tag] = rec.expected()
            log(f"  {tag}: {dt:.2f} s, {gib_s(nbytes, dt):.2f} GiB/s, K1 "
                f"launches {counts[tag]['gf_apply']}")
            return text

        obj = f"{confs['native:4']}#obj"
        step("hc_cli_cp_native", ["cp", src, obj], txt, total)
        step("hc_cli_cat_native", ["cat", obj], out, total)
        assert same_file(src, out), "cat on native:4 differs"
        report = step("hc_cli_verify_native", ["verify", obj], txt,
                      total).decode()
        assert report.startswith("file\tValid"), report[:200]
        step("hc_cli_cp_cuda", ["cp", src, f"{confs['cuda']}#obj"], txt,
             total)
        assert counts["hc_cli_cp_cuda"]["gf_apply"] > 0
        for tag in ("hc_cli_cp_native", "hc_cli_cat_native",
                    "hc_cli_verify_native"):
            assert counts[tag]["gf_apply"] == 0, (tag, counts[tag])

        def chunk_hashes(conf: str) -> list:
            with open(os.path.join(os.path.dirname(conf), "meta",
                                   "obj")) as f:
                ref = yaml.safe_load(f)
            return [[c["sha256"] for c in part["data"] + part["parity"]]
                    for part in ref["parts"]]

        assert chunk_hashes(confs["native:4"]) == chunk_hashes(confs["cuda"])
        log(f"  native:4: cat equal to the source, verify Valid, the "
            f"reference equal to the cuda YAML's ({HC_CLI_PARTS + 1} "
            f"parts)")
    stamp("host_codec cli")

    # ---- (4) config 12: table kernels and the scheduled-XOR engine ----
    rng = np.random.default_rng(SEED + 12)
    oracle = NumpyBackend()
    table = cpu_backend.NativeBackend(xor_schedule=False)
    xor = cpu_backend.NativeBackend(xor_schedule=True)

    def best(fn, iters: int = 3) -> float:
        out = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            out = min(out, time.perf_counter() - t0)
        return out

    cells = []
    for d, p in C12_GEOMETRIES:
        enc = matrix.build_encode_matrix(d, p)
        for size in C12_SIZES:
            b = max(1, C12_WORKING_SET // (d * size))
            data = rng.integers(0, 256, (b, d, size), dtype=np.uint8)
            nbytes = b * d * size
            for leg in ("encode", "decode"):
                if leg == "encode":
                    mat, src = enc[d:], data
                else:
                    full_rows = np.concatenate(
                        [data, table.apply_matrix(enc[d:], data)], axis=1)
                    lost = sorted(rng.choice(d + p, size=p,
                                             replace=False).tolist())
                    present = [i for i in range(d + p) if i not in lost]
                    mat = matrix.decode_matrix(enc, present, lost)
                    src = np.ascontiguousarray(
                        full_rows[:, np.array(present[:d])])
                want = table.apply_matrix(mat, src)
                assert np.array_equal(xor.apply_matrix(mat, src), want), \
                    (d, p, size, leg)
                n = min(b, C12_ORACLE_PARTS)
                assert np.array_equal(oracle.apply_matrix(mat, src[:n]),
                                      want[:n]), (d, p, size, leg)
                if leg == "decode":
                    assert np.array_equal(want, full_rows[:, lost])
                t_table = best(lambda: table.apply_matrix(mat, src))
                cpu_backend.gf_force_level(0)
                try:
                    t_scalar = best(lambda: table.apply_matrix(mat, src))
                finally:
                    cpu_backend.gf_force_level(2)
                t_xor = best(lambda: xor.apply_matrix(mat, src))
                cell = {"d": d, "p": p, "size_kib": size >> 10, "leg": leg,
                        "table": gib_s(nbytes, t_table),
                        "table_scalar": gib_s(nbytes, t_scalar),
                        "xor": gib_s(nbytes, t_xor)}
                cells.append(cell)
                log(f"  config 12 d{d}p{p} {size >> 10} KiB {leg}: host "
                    f"GiB/s on the card's box: table {cell['table']:.2f} "
                    f"(scalar {cell['table_scalar']:.2f}), xor "
                    f"{cell['xor']:.2f}")
    wins = sum(c["xor"] > c["table"] for c in cells)
    wins_scalar = sum(c["xor"] > c["table_scalar"] for c in cells)
    log(f"  config 12: every cell byte-identical to numpy with "
        f"CHUNKY_BITS_TORCH_XOR_SCHEDULE's engine off and on; xor beats "
        f"the best table tier in {wins}/{len(cells)} cells, the scalar "
        f"table in {wins_scalar}/{len(cells)}")
    rec.close()
    return expected


# ---- the serving_opt_in group ----

#: BASELINE.md config 19 (bench.py:3543ff, BASELINE.md:721-765): d=3 p=2,
#: 64 KiB chunks, max_concurrent_gets 4, a read cache far below the object
#: (every GET fetches and verifies), 16 flooding keep-alive clients of
#: tenant "other", a victim tenant (weight 4, by X-Api-Key) issuing 40
#: sequential 512 KiB reads 50 ms apart; clients back off 20 ms on a 503
C19_CAP, C19_ANTAGONISTS, C19_READS = 4, 16, 40
C19_OBJECT, C19_CACHE = 512 << 10, 1 << 14
C19_SATURATE_S, C19_PACE_S, C19_BACKOFF_S = 2.0, 0.05, 0.02
C19_VICTIM_KEY = "victim-key"
#: config 15's engine-off overhead leg (BASELINE.md:544-561): 400
#: sequential hot 64 KiB GETs a leg, legs off, on, on, off, the engine
#: ticking every 0.05 s when on
C15_GETS, C15_OBJECT, C15_EVAL_S = 400, 64 << 10, 0.05
#: the live alert: short windows so that availability fires and resolves
#: within seconds; one GET body at a time, so a burst sheds
ALERT_SLO = {"fast_s": 1.0, "slow_s": 3.0, "clear_s": 1.0}
ALERT_EVAL_S, ALERT_FLOOD, ALERT_BACKOFF_S = 0.05, 8, 0.005
#: multi-host on one card: 256 parts of d=10 p=4 at 1 MiB over two
#: processes, each on local_mesh(sp=2) of 4 logical devices of cuda:0,
#: 32 parts a block
MH_PARTS, MH_BLOCK, MH_DEVICES, MH_PROCESSES = 256, 32, 4, 2


def mh_part(index: int) -> np.ndarray:
    """Part ``index`` of the multi-host batch, uint8 [D, CHUNK], made from
    (seed, part index) alone, so every process makes only its own."""
    rng = np.random.default_rng((SEED, index))
    return np.frombuffer(rng.bytes(D * CHUNK), dtype=np.uint8).reshape(
        D, CHUNK)


def multihost_worker(argv: list[str]) -> int:
    """One process of the multi-host step (``--multihost-worker ADDRESS
    WORLD RANK OUT``): join the gloo group through ``init_multihost``,
    encode this process's ``partition_parts`` slice through
    ``encode_step_sharded`` on ``local_mesh(sp=2)``, write its parity to
    ``OUT/rank<i>.npy``, exchange the summaries over the group and print
    this process's as one JSON line."""
    import torch
    import torch.distributed as dist

    from chunky_bits_tpu_torch.ops import gf_kernel, matrix
    from chunky_bits_tpu_torch.parallel import (encode_step_sharded,
                                                init_multihost, local_mesh,
                                                partition_parts)

    address, world, rank, out = argv
    index, count = init_multihost(address, int(world), int(rank),
                                  timeout_s=300)
    try:
        start, stop = partition_parts(MH_PARTS)
        mesh = local_mesh(sp=2)
        enc = matrix.build_encode_matrix(D, P)
        parity = np.lib.format.open_memmap(
            os.path.join(out, f"rank{index}.npy"), mode="w+",
            dtype=np.uint8, shape=(stop - start, P, CHUNK))
        gf_kernel.LAUNCHES = gf_kernel.PACKED_LAUNCHES = 0
        checksum, blocks, encode_s, make_s = 0, 0, 0.0, 0.0
        for lo in range(start, stop, MH_BLOCK):
            hi = min(lo + MH_BLOCK, stop)
            t0 = time.perf_counter()
            data = np.stack([mh_part(i) for i in range(lo, hi)])
            t1 = time.perf_counter()
            got, cs = encode_step_sharded(mesh, enc, data)
            encode_s += time.perf_counter() - t1
            make_s += t1 - t0
            parity[lo - start:hi - start] = got
            checksum = (checksum + cs) & 0xFFFFFFFF
            blocks += 1
        parity.flush()
        del parity
        mine = {"rank": index, "world": count, "start": start,
                "stop": stop, "blocks": blocks, "checksum": checksum,
                "gf_apply": gf_kernel.LAUNCHES,
                "gf_apply_packed": gf_kernel.PACKED_LAUNCHES,
                "devices": int(mesh.devices.size),
                "device": str(mesh.devices.flat[0].device),
                "backend": dist.get_backend(),
                "encode_s": encode_s, "make_s": make_s,
                "gpu": torch.cuda.get_device_name(0)}
        gathered = [None] * count
        dist.all_gather_object(gathered, mine)
        mine["gathered_ranks"] = [g["rank"] for g in gathered]
        print(json.dumps(mine), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


async def c19_flood(port: int, payload: bytes, seconds: float = 0.0
                    ) -> dict:
    """BASELINE config 19's mix against the gateway on ``port``, whose
    ``/obj`` holds ``payload``: ``C19_ANTAGONISTS`` keep-alive clients of
    tenant ``other`` flood it, and after ``C19_SATURATE_S`` the victim
    tenant reads it ``C19_READS`` times ``C19_PACE_S`` apart (or, with
    ``seconds``, until that long after the flood began), every victim
    body and every eighth antagonist body held against ``payload``; a
    503 backs off ``C19_BACKOFF_S`` and retries.  Returns the victim's
    latency percentiles, the requests/s served and the sheds."""
    from chunky_bits_tpu_torch.file.profiler import percentile

    state = {"stop": False, "ok": 0, "shed": 0, "victim_shed": 0}
    deadline = time.perf_counter() + seconds

    async def fetch_ok(conn, extra: str, victim: bool):
        t0 = time.perf_counter()
        while True:
            status, body, _e = await conn.get("/obj", extra)
            if status == 200:
                return time.perf_counter() - t0, body
            assert status == 503, status
            state["shed"] += 1
            state["victim_shed"] += victim
            await asyncio.sleep(C19_BACKOFF_S)

    async def antagonist() -> None:
        conn = await MiniConn(port).open()
        try:
            j = 0
            while not state["stop"]:
                _w, body = await fetch_ok(conn, "", False)
                state["ok"] += 1
                j += 1
                if j % 8 == 0:
                    assert body == payload, "antagonist body"
        finally:
            await conn.close()

    tasks = [asyncio.ensure_future(antagonist())
             for _ in range(C19_ANTAGONISTS)]
    await asyncio.sleep(C19_SATURATE_S)
    lat = []
    conn = await MiniConn(port).open()
    t_open = time.perf_counter()
    try:
        while (time.perf_counter() < deadline if seconds
               else len(lat) < C19_READS):
            wall, body = await fetch_ok(
                conn, f"X-Api-Key: {C19_VICTIM_KEY}\r\n", True)
            assert body == payload, "victim body differs"
            state["ok"] += 1
            lat.append(wall)
            await asyncio.sleep(C19_PACE_S)
    finally:
        window = time.perf_counter() - t_open
        state["stop"] = True
        done = await asyncio.gather(*tasks, return_exceptions=True)
        await conn.close()
    errors = [e for e in done if e is not None]
    assert not errors, errors[:2]
    lat.sort()
    return {"victim_p50_ms": percentile(lat, 50) * 1e3,
            "victim_p99_ms": percentile(lat, 99) * 1e3,
            "rps": state["ok"] / window, "ok": state["ok"],
            "sheds": state["shed"], "victim_sheds": state["victim_shed"],
            "victim_reads": len(lat)}


def phase_serving_opt_in(path, counts, be, tp_rec) -> dict:
    """The serving_opt_in group: the serving plane's opt-in parts on the
    card.  (1) BASELINE config 19's QoS A/B: a gateway on ``cuda`` with
    QoS off, then on, under a 16-client flood of tenant ``other`` and a
    paced victim tenant, every victim body held against its source; the
    ON leg must shed no victim read, and its ``cb_qos_*`` samples on
    /metrics must equal the scheduler's ``stats()``.  (2) config 15's
    engine-off overhead: two gateways on ``cuda`` over one tree, the SLO
    engine off and on (0.05 s ticks), 400 sequential hot GETs a leg, legs
    off, on, on, off.  (3) a live alert: a gateway with short SLO windows
    and one GET body at a time; a flood of concurrent GETs sheds 503s, and
    ``availability`` must fire within ``slow_s`` + 1 s, agree on
    /alerts, /metrics, /stats and ``python -m chunky_bits_tpu_torch stats
    --json``, then resolve after its hold-down under healthy GETs with one
    entry in its history.  (4) multi-host on one card: two processes join
    a gloo group through ``init_multihost`` and each encodes its
    ``partition_parts`` slice of 256 config-2 parts on ``local_mesh(sp=2)``
    over 4 logical devices; the concatenated parity must equal the
    single-process ``cuda`` coder's, a sample numpy's, each child's
    checksum its slice's and its K1 launches its blocks times its devices.
    Each in-process step is a path of its own, its K1 launches checked
    against the ``cuda`` backend's recorded dispatches.  Returns the
    expected launches of its paths."""
    import gc
    import socket
    import tempfile

    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.cluster.tunables import (BACKEND_ENV,
                                                        environ_without)
    from chunky_bits_tpu_torch.gateway import serve
    from chunky_bits_tpu_torch.obs import metrics as obs_metrics
    from chunky_bits_tpu_torch.ops.backend import get_backend, get_coder
    from chunky_bits_tpu_torch.utils.yamlio import yaml_load

    expected = {}
    rec = ApplyRecorder(be)
    here = os.path.dirname(os.path.abspath(__file__))

    def step(name: str, fn, *args):
        t0 = time.perf_counter()
        out = path(name, fn, *args)
        dt = time.perf_counter() - t0
        want, mesh = rec.expected(), tp_rec.expected()
        expected[name] = {k: want[k] + mesh[k] for k in KERNELS}
        log(f"  {name}: {dt:.2f} s, K1 launches {counts[name]['gf_apply']}")
        return out

    def start_gateway(conf: str, gets: int) -> ServerThread:
        with open(conf) as f:
            cluster = Cluster.from_obj(yaml_load(f.read()))

        def run(on_ready):
            return serve(cluster, "127.0.0.1", 0, max_concurrent_gets=gets,
                         on_ready=on_ready)

        server = ServerThread(run, "gateway")
        server.cluster = cluster
        return server

    def put(port: int, name: str, data: bytes) -> None:
        status, _h, resp = http_request(port, "PUT", f"/{name}",
                                        body_parts=(data,),
                                        body_len=len(data))
        resp.read()
        assert status == 200, (name, status)

    def get_json(port: int, url_path: str) -> dict:
        status, _h, resp = http_request(port, "GET", url_path)
        assert status == 200, (url_path, status)
        return json.loads(resp.read())

    rng = np.random.default_rng(SEED + 19)
    with tempfile.TemporaryDirectory(prefix="cb-slo-") as root:
        # ---- (1) BASELINE config 19's QoS A/B ----
        payload = rng.integers(0, 256, C19_OBJECT, dtype=np.uint8).tobytes()
        legs = {}
        for qos_on in (False, True):
            leg = "on" if qos_on else "off"
            top = os.path.join(root, f"c19{leg}")
            os.makedirs(top)
            conf = cluster_yaml(top, CONFIG9, "cuda", cache_bytes=C19_CACHE,
                                extra={"qos": {
                                    "enabled": qos_on,
                                    "tenants": {"victim": {
                                        "weight": 4,
                                        "keys": [C19_VICTIM_KEY]}}}})
            gw = start_gateway(conf, C19_CAP)
            port = gw.port
            step(f"c19_put_{leg}", put, port, "obj", payload)

            got = step(f"c19_qos_{leg}",
                       lambda: asyncio.run(c19_flood(port, payload)))
            fams = parse_metrics(port)
            stats = get_json(port, "/stats")
            scheds = obs_metrics.get_registry().sources("qos")
            if qos_on:
                assert len(scheds) == 1, scheds
                want = scheds[0].stats()
                assert stats["qos"] == want.to_obj(), (stats["qos"], want)

                def sample(name: str, **labels) -> float:
                    hits = [v for _n, lab, v in fams[name]["samples"]
                            if lab == labels]
                    assert len(hits) == 1, (name, labels, hits)
                    return hits[0]

                for row in want.rows:
                    for key in ("admitted", "shed", "bytes",
                                "throttle_waits", "queued"):
                        name = (f"cb_qos_{key}" if key == "queued"
                                else f"cb_qos_{key}_total")
                        assert sample(name, tenant=row.tenant) == \
                            getattr(row, key), (name, row)
                assert sample("cb_qos_pressure") == want.pressure
                assert sample("cb_qos_hedge_suppressed_total") == \
                    want.hedge_suppressed
                assert sample("cb_qos_hedge_conserved_total") == \
                    want.hedge_conserved
                assert got["victim_sheds"] == 0, got
                rows = {r.tenant: r for r in want.rows}
                got["admitted"] = {t: r.admitted for t, r in rows.items()}
                got["queue_peak"] = {t: r.queue_peak
                                     for t, r in rows.items()}
                log(f"  cb_qos_* on /metrics equal the scheduler's stats(): "
                    f"{want}")
            else:
                assert not scheds and stats["qos"] == {"enabled": False}
                assert not any(n.startswith("cb_qos_") for n in fams)
            legs[leg] = got
            log(f"  config 19 QoS {leg}: victim p50 "
                f"{got['victim_p50_ms']:.2f} ms p99 "
                f"{got['victim_p99_ms']:.2f} ms, {got['rps']:.1f} "
                f"requests/s, {got['sheds']} sheds ({got['victim_sheds']} "
                f"of the victim), {got['ok']} bodies")
            gw.stop()
            del gw
        ratio = legs["off"]["victim_p99_ms"] / legs["on"]["victim_p99_ms"]
        log(f"config 19 on the card: victim p99 off/on {ratio:.2f}x (the "
            f"CPU run's bar: 5x, recorded, not gated); aggregate "
            f"requests/s on/off "
            f"{legs['on']['rps'] / legs['off']['rps']:.3f}; every victim "
            f"body equal to its source in both legs; {json.dumps(legs)}")
        stamp("serving_opt_in config 19")

        # ---- (2) config 15's engine-off overhead ----
        top = os.path.join(root, "c15")
        os.makedirs(top)
        conf_off = cluster_yaml(top, CONFIG9, "cuda", cache_bytes=GW_CACHE)
        with open(conf_off) as f:
            spec = yaml_load(f.read())
        spec["tunables"]["slo_eval_s"] = C15_EVAL_S
        conf_on = os.path.join(top, "cluster-slo.yaml")
        with open(conf_on, "w") as f:
            json.dump(spec, f)
        hot = rng.integers(0, 256, C15_OBJECT, dtype=np.uint8).tobytes()
        confs = {"off": conf_off, "on": conf_on}

        async def sequential(port: int) -> float:
            conn = await MiniConn(port).open()
            try:
                status, body, _e = await conn.get("/hot")
                assert status == 200 and body == hot
                t0 = time.perf_counter()
                for _ in range(C15_GETS):
                    status, body, _e = await conn.get("/hot")
                    assert status == 200 and body == hot
                return C15_GETS / (time.perf_counter() - t0)
            finally:
                await conn.close()

        # one gateway a leg, so an off leg shares its interpreter with no
        # engine ticking
        rates, evals = [], 0
        for i, leg in enumerate(("off", "on", "on", "off")):
            gw = start_gateway(confs[leg], 256)
            if i == 0:
                step("c15_put", put, gw.port, "hot", hot)
            rps = step(f"c15_engine_{leg}{i}",
                       lambda: asyncio.run(sequential(gw.port)))
            alerts = get_json(gw.port, "/alerts")
            if leg == "on":
                evals += alerts["evaluations"]
                assert alerts["evaluations"] > 0, alerts
            else:
                assert alerts == {"enabled": False}, alerts
            gw.stop()
            del gw
            rates.append((leg, rps))
            log(f"  config 15 engine {leg}: {rps:.1f} requests/s")
        off = statistics.mean(r for leg, r in rates if leg == "off")
        on = statistics.mean(r for leg, r in rates if leg == "on")
        log(f"config 15 overhead on the card: off {off:.1f}, on {on:.1f} "
            f"requests/s, on/off {on / off:.3f} ({evals} evaluations in "
            f"the on legs' gateways)")
        stamp("serving_opt_in config 15")

        # ---- (3) a live alert ----
        gc.collect()  # drop earlier groups' scoreboards from the registry
        top = os.path.join(root, "alert")
        os.makedirs(top)
        conf = cluster_yaml(top, CONFIG9, "cuda", extra={
            "slo_eval_s": ALERT_EVAL_S, "slo": dict(ALERT_SLO),
            "qos": {"enabled": False}})
        gw = start_gateway(conf, 1)
        port = gw.port
        step("alert_put", put, port, "obj", payload)
        url = f"http://127.0.0.1:{port}"

        def availability() -> dict:
            alerts = get_json(port, "/alerts")
            return next(a for a in alerts["alerts"]
                        if a["rule"] == "availability"), alerts

        async def alert_run() -> dict:
            out = {}
            conn = await MiniConn(port).open()
            t_end = time.perf_counter() + ALERT_SLO["slow_s"]
            while time.perf_counter() < t_end:  # healthy traffic first
                status, body, _e = await conn.get("/obj")
                assert status == 200 and body == payload
            row, _a = await asyncio.to_thread(availability)
            assert row["state"] == "inactive", row
            state = {"stop": False, "sheds": 0, "ok": 0}

            async def flooder() -> None:
                c = await MiniConn(port).open()
                try:
                    while not state["stop"]:
                        status, body, _e = await c.get("/obj")
                        if status == 503:
                            state["sheds"] += 1
                            await asyncio.sleep(ALERT_BACKOFF_S)
                        else:
                            assert status == 200 and body == payload
                            state["ok"] += 1
                finally:
                    await c.close()

            t_burst = time.perf_counter()
            tasks = [asyncio.ensure_future(flooder())
                     for _ in range(ALERT_FLOOD)]
            try:
                limit = ALERT_SLO["slow_s"] + 1.0
                while True:
                    row, alerts = await asyncio.to_thread(availability)
                    if row["state"] == "firing":
                        break
                    assert time.perf_counter() - t_burst < limit, \
                        ("availability did not fire in time", row, state)
                    await asyncio.sleep(0.05)
                out["detect_s"] = time.perf_counter() - t_burst
                out["value_fast"] = row["value_fast"]
                # every surface agrees while the flood goes on
                sheds = state["sheds"]
                fams = await asyncio.to_thread(parse_metrics, port)
                gauge = [v for _n, lab, v in
                         fams["cb_alerts_state"]["samples"]
                         if lab.get("rule") == "availability"]
                stats = await asyncio.to_thread(get_json, port, "/stats")
                cli = await asyncio.to_thread(
                    subprocess.run,
                    [sys.executable, "-m", "chunky_bits_tpu_torch",
                     "--config", os.devnull, "stats", "--json", url],
                    cwd=here, env=environ_without(BACKEND_ENV), check=True,
                    timeout=300, capture_output=True, text=True)
                blob = json.loads(cli.stdout)
                row_after, _a = await asyncio.to_thread(availability)
                assert 2 in gauge, gauge
                assert "availability" in alerts["firing"], alerts["firing"]
                assert "availability" in stats["slo"]["firing"], \
                    stats["slo"]
                assert "availability" in blob["alerts"]["firing"], \
                    blob["alerts"]["firing"]
                assert [a["state"] for a in blob["alerts"]["alerts"]
                        if a["rule"] == "availability"] == ["firing"]
                assert row_after["state"] == "firing", row_after
                five = [v for _n, lab, v in
                        fams["cb_request_total"]["samples"]
                        if lab.get("status_class") == "5xx"]
                assert sum(five) >= sheds > 0, (five, sheds)
            finally:
                state["stop"] = True
                done = await asyncio.gather(*tasks, return_exceptions=True)
            assert not [e for e in done if e is not None], done
            out["flood"] = dict(state)
            out["flood_s"] = time.perf_counter() - t_burst
            t_stop = time.perf_counter()
            healthy = 0
            while True:
                status, body, _e = await conn.get("/obj")
                assert status == 200 and body == payload
                healthy += 1
                row, alerts = await asyncio.to_thread(availability)
                if row["state"] == "inactive":
                    break
                assert time.perf_counter() - t_stop < 30, row
            out["resolve_s"] = time.perf_counter() - t_stop
            out["healthy_gets"] = healthy
            await conn.close()
            mine = [e for e in alerts["history"]
                    if e["rule"] == "availability"]
            assert len(mine) == 1 and mine[0]["resolved_at"] is not None, \
                alerts["history"]
            out["history"] = alerts["history"]
            out["fired_count"] = row["fired_count"]
            return out

        got = step("alert_availability", lambda: asyncio.run(alert_run()))
        gw.stop()
        del gw
        log(f"live alert on the card (slo_eval_s {ALERT_EVAL_S}, "
            f"{ALERT_SLO}, max_concurrent_gets 1): availability firing "
            f"{got['detect_s']:.2f} s after the flood began (limit "
            f"{ALERT_SLO['slow_s'] + 1.0:.1f} s), fast-window 5xx ratio "
            f"{got['value_fast']}; /alerts, cb_alerts_state, /stats and "
            f"`stats --json` agreed; {got['flood']['sheds']} sheds in "
            f"{got['flood_s']:.2f} s of flood; resolved "
            f"{got['resolve_s']:.2f} s after it under "
            f"{got['healthy_gets']} healthy GETs; history "
            f"{got['history']}")
        stamp("serving_opt_in live alert")

        # ---- (4) multi-host on one card ----
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{sock.getsockname()[1]}"
        out_dir = os.path.join(root, "mh")
        os.makedirs(out_dir)
        env = dict(environ_without(BACKEND_ENV),
                   CHUNKY_BITS_TORCH_VIRTUAL_DEVICES=str(MH_DEVICES))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--multihost-worker", address, str(MH_PROCESSES), str(r),
             out_dir], cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for r in range(MH_PROCESSES)]
        reports = []
        try:
            for proc in procs:
                stdout, stderr = proc.communicate(timeout=300)
                assert proc.returncode == 0, stderr[-3000:]
                reports.append(json.loads(stdout.strip().splitlines()[-1]))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        enc = get_coder(D, P).encode_matrix
        spans = [(r["start"], r["stop"]) for r in reports]
        assert spans == [(0, MH_PARTS // 2), (MH_PARTS // 2, MH_PARTS)], spans
        for r in reports:
            n = r["stop"] - r["start"]
            assert r["world"] == MH_PROCESSES and r["backend"] == "gloo", r
            assert r["gathered_ranks"] == list(range(MH_PROCESSES)), r
            assert r["blocks"] == -(-n // MH_BLOCK), r
            assert r["devices"] == MH_DEVICES and r["device"] == "cuda:0", r
            assert r["gf_apply"] == r["blocks"] * MH_DEVICES, r
            assert r["gf_apply_packed"] == 0, r

        def reference() -> None:
            coder = get_coder(D, P)
            numpy_be = get_backend("numpy")
            parity = [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                              mmap_mode="r") for r in range(MH_PROCESSES)]
            sums = [0] * MH_PROCESSES
            for lo in range(0, MH_PARTS, KERNEL_PARTS):
                hi = min(lo + KERNEL_PARTS, MH_PARTS)
                data = np.stack([mh_part(i) for i in range(lo, hi)])
                want = coder.encode_batch(data)
                for i in range(lo, hi):
                    r = next(k for k, (a, b) in enumerate(spans)
                             if a <= i < b)
                    assert np.array_equal(parity[r][i - spans[r][0]],
                                          want[i - lo]), i
                    sums[r] += int(want[i - lo].sum(dtype=np.uint64))
                for j in (0, hi - lo - 1):
                    assert np.array_equal(
                        numpy_be.apply_matrix(enc[D:], data[j:j + 1])[0],
                        want[j]), lo + j
            for r, rep in enumerate(reports):
                assert rep["checksum"] == sums[r] & 0xFFFFFFFF, (r, rep)

        step("multihost_reference", reference)
        for r in reports:
            nbytes = (r["stop"] - r["start"]) * D * CHUNK
            log(f"  multi-host process {r['rank']} of {r['world']} "
                f"({r['backend']}, {r['devices']} logical devices of "
                f"{r['device']}, {r['gpu']}): parts [{r['start']}, "
                f"{r['stop']}) in {r['blocks']} blocks, "
                f"{r['gf_apply']} K1 launches, encode "
                f"{gib_s(nbytes, r['encode_s']):.2f} GiB/s "
                f"({r['encode_s']:.2f} s; making the parts {r['make_s']:.2f} "
                f"s), checksum {r['checksum']:#010x}")
        log(f"multi-host on one card: {MH_PROCESSES} processes in "
            f"{wall:.1f} s (start-up included); the concatenated parity "
            f"equals the single-process cuda coder's, the first and last "
            f"part of each of its blocks numpy's, and each checksum its "
            f"slice's")
        stamp("serving_opt_in multi-host")
    rec.close()
    return expected


SIM_NODES = 100        # BASELINE config 14's fleet (bench.py:2642)
SIM_BIG_NODES = 1000   # the README's thousand-node run
SIM_SEED = 0
SIM_CHUNK = 4 << 10    # ScenarioEnv's chunk_log2 of 12
#: the one verdict that fails at N=1000 in the JAX package too: the
#: breaker-open detection bound (1500 s) was tuned at N=100, and at N=1000
#: a partitioned node meets too few requests a pass to trip its breaker
SIM_BIG_FALSE = {"slo_detected_breaker_open"}


def first_trace_difference(a: bytes, b: bytes) -> str:
    for i, (x, y) in enumerate(zip(a.decode().splitlines(),
                                   b.decode().splitlines())):
        if x != y:
            return f"first differing line {i}:\n  {x}\n  {y}"
    return f"{len(a)} and {len(b)} bytes, one a prefix of the other"


def phase_simulator(path, counts, be, tp_rec) -> dict:
    """The simulator group: the port's scenario library, SLO detection and
    crash harness on the card, in this process, their clusters naming no
    backend and so running on ``cuda``.  (1) BASELINE config 14: all ten
    scenarios at N=100, seed 0, every verdict true; (2) the README's
    thousand-node ``az_outage``, its verdicts those of the JAX package at
    that size; (3) determinism: ``az_outage`` at N=100 again on ``cuda``
    and once on ``torch`` (the box's CPU), all three traces byte-identical
    and both ``cuda`` metrics snapshots equal; (4) config 15's detection
    leg, read from the config-14 runs: every expected alert fires within
    its bound and resolves, none fires outside the fault windows, and
    ``thundering_herd`` run again gives the same detection report and
    trace; (5) config 16: the crash matrix over all eight mutations twice
    (every image clean, one digest), then ``run_cluster_recovery`` with
    its full set of crash points (``scrub --once`` converges every image
    to Valid with byte-identical reads).  Every step but the ``torch`` run
    is a path whose K1 launches are nonzero and checked against the
    ``cuda`` backend's recorded dispatches.  Returns the expected launches
    of its paths, and the first ``az_outage`` run at N=100 (its trace and
    its workdir path) for the sanitizer group."""
    import shutil
    import tempfile

    from chunky_bits_tpu_torch.cluster.tunables import (BACKEND_ENV,
                                                        env_str,
                                                        set_default_backend)
    from chunky_bits_tpu_torch.ops.backend import get_backend
    from chunky_bits_tpu_torch.sim import crash
    from chunky_bits_tpu_torch.sim.scenario import (SCENARIOS, fresh_workdir,
                                                    run_scenario)

    assert be.name == "cuda" and get_backend() is be, get_backend().name
    expected = {}
    rec = ApplyRecorder(be)
    t_group = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cb_sim_")
    workdir = os.path.join(tmp, "scenario")

    def step(name: str, fn, *args):
        out = path(name, fn, *args)
        want, mesh = rec.expected(), tp_rec.expected()
        expected[name] = {k: want[k] + mesh[k] for k in KERNELS}
        assert counts[name]["gf_apply"] > 0, (name, counts[name])
        return out

    def scenario(name: str, nodes: int):
        # one workdir path for every run, so metadata paths (and so the
        # traces) are string-identical run to run
        return run_scenario(name, nodes=nodes, seed=SIM_SEED,
                            workdir=fresh_workdir(workdir))

    def report(tag: str, result) -> None:
        log(f"  {tag}: {result.virtual_seconds:.1f} virtual s in "
            f"{result.wall_seconds:.2f} s wall ({result.compression():.1f}x)"
            f", {result.trace.count(b'\n')} trace events, "
            f"{result.details['client_reads']} client reads, K1 launches "
            f"{counts[tag]['gf_apply'] if tag in counts else 0}")

    def failed(result) -> set:
        return {k for k, v in result.verdicts.items() if not v}

    try:
        # (1) config 14: the library at its own size
        results = {}
        for name in sorted(SCENARIOS):
            tag = f"sim_{name}"
            result = step(tag, scenario, name, SIM_NODES)
            assert result.ok(), (name, failed(result),
                                 result.trace.decode()[-2000:])
            results[name] = result
            report(tag, result)
        virtual = sum(r.virtual_seconds for r in results.values())
        wall = sum(r.wall_seconds for r in results.values())
        log(f"config 14 on cuda: {len(results)} scenarios x {SIM_NODES} "
            f"nodes, every verdict true: {virtual:.1f} virtual s in "
            f"{wall:.2f} s wall ({virtual / wall:.1f}x)")
        stamp("simulator config 14")

        # (2) the thousand-node run
        big = step("sim_az_outage_n1000", scenario, "az_outage",
                   SIM_BIG_NODES)
        assert failed(big) == SIM_BIG_FALSE, (failed(big), big.verdicts)
        report("sim_az_outage_n1000", big)
        log(f"az_outage at N={SIM_BIG_NODES}: {big.compression():.1f}x; "
            f"every verdict true but {sorted(SIM_BIG_FALSE)}, which is "
            f"false in the JAX package at this size too")

        # (3) determinism: cuda twice, torch once, one workdir path
        first = results["az_outage"]
        again = step("sim_az_outage_again", scenario, "az_outage",
                     SIM_NODES)
        report("sim_az_outage_again", again)
        # the CLI's --backend for this one run; unset and "cuda" resolve
        # alike, so the default goes back to what it was
        previous = env_str(BACKEND_ENV) or "cuda"
        set_default_backend("torch")
        try:
            on_torch = scenario("az_outage", SIM_NODES)
        finally:
            set_default_backend(previous)
        assert get_backend() is be
        report("az_outage on torch", on_torch)
        for other, label in ((again, "cuda again"), (on_torch, "torch")):
            assert other.trace == first.trace, (
                f"az_outage trace on {label} differs from the first cuda "
                f"run: " + first_trace_difference(first.trace, other.trace))
        assert again.metrics == first.metrics, "cuda metrics snapshots differ"
        assert on_torch.verdicts == first.verdicts
        log(f"determinism: az_outage at N={SIM_NODES}, seed {SIM_SEED}: "
            f"traces byte-identical on cuda, cuda and torch "
            f"({len(first.trace)} bytes, {first.trace.count(b'\n')} "
            f"events), both cuda metrics snapshots equal")
        stamp("simulator determinism")

        # (4) config 15's detection leg, from the config-14 runs
        rows = 0
        for name, result in sorted(results.items()):
            slo = result.details["slo"]
            assert slo["false_positives"] == 0, (name, slo)
            for rule, cfg in sorted(SCENARIOS[name].slo.get(
                    "expected", {}).items()):
                latency = slo["detect_latency_s"].get(rule)
                assert latency is not None and latency <= cfg["within_s"], (
                    name, rule, slo)
                assert result.verdicts[f"slo_detected_{rule}"], (name, rule)
                rows += 1
                log(f"  config 15 {name}.{rule}: detected {latency:.3f} "
                    f"virtual s after the fault (bound {cfg['within_s']:.0f}"
                    f" s), resolved")
        herd = step("sim_thundering_herd_again", scenario, "thundering_herd",
                    SIM_NODES)
        report("sim_thundering_herd_again", herd)
        assert herd.details["slo"] == results["thundering_herd"].details[
            "slo"], "thundering_herd detection reports differ"
        assert herd.trace == results["thundering_herd"].trace, (
            "thundering_herd traces differ: " + first_trace_difference(
                results["thundering_herd"].trace, herd.trace))
        log(f"config 15 detection on cuda: {rows} expected alerts each "
            f"within its bound and resolved, 0 false positives over "
            f"{len(results)} scenarios; thundering_herd twice: equal "
            f"detection reports and traces")
        stamp("simulator config 15")

        # (5) config 16: the crash matrix twice, then cluster recovery
        def config16():
            matrix_dir = os.path.join(tmp, "matrix")
            runs = [crash.run_matrix(matrix_dir, seed=SIM_SEED)
                    for _ in range(2)]
            recovery = crash.run_cluster_recovery(
                os.path.join(tmp, "recovery"), seed=SIM_SEED, points="full")
            return runs, recovery

        t0 = time.perf_counter()
        (one, two), recovery = step("sim_crash", config16)
        dt = time.perf_counter() - t0
        assert one.ok(), [v.to_obj() for v in one.failed()[:5]]
        assert one.digest == two.digest, (one.digest, two.digest)
        assert [v.to_obj() for v in one.verdicts] \
            == [v.to_obj() for v in two.verdicts]
        assert sorted(one.ops_by_mutation) == sorted(crash.MUTATIONS)
        for row in one.rows():
            log(f"  config 16 {row['mutation']}: {row['ops']} durability "
                f"ops, {row['ops'] + 1} crash points, {row['images']} "
                f"images, {row['images_ok']} clean")
        assert recovery and all(v.ok for v in recovery), \
            [v.to_obj() for v in recovery]
        modes = ", ".join(sorted({v.mode for v in recovery}))
        log(f"config 16: {len(one.verdicts)} crash images over "
            f"{one.crash_points()} crash points, all clean, digest "
            f"{one.digest} twice; cluster recovery: {len(recovery)} images "
            f"({modes}) each Valid after scrub --once with byte-identical "
            f"reads; {dt:.1f} s, K1 launches "
            f"{counts['sim_crash']['gf_apply']}")
    finally:
        rec.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"simulator group: {time.perf_counter() - t_group:.1f} s")
    return expected, {"trace": first.trace, "workdir": workdir}


# ---- the sanitizer group ----

#: the sanitized ingest and degraded read: ~1 GiB of config 2 (100 parts
#: of d=10 p=4 at 1 MiB, and the tail)
SAN_PARTS = DISK_PARTS
#: config 19's QoS-on leg under the sanitizer: the flood runs this long
SAN_GW_SECONDS = 10.0
SAN_STEPS = ("ingest", "degraded_read", "gateway", "scenario")
#: a range inside config 19's 512 KiB object, across a chunk boundary
SAN_RANGE = (60000, 70999)


def zero_counts() -> None:
    """Set every kernel's launch count to 0."""
    from chunky_bits_tpu_torch.ops import gf_kernel, sha256

    gf_kernel.LAUNCHES = 0
    gf_kernel.PACKED_LAUNCHES = 0
    gf_kernel.ACC_LAUNCHES = 0
    gf_kernel.REDUCE_PACK_LAUNCHES = 0
    sha256.LAUNCHES = 0


def read_counts() -> dict:
    """Every kernel's launch count since ``zero_counts``."""
    from chunky_bits_tpu_torch.ops import gf_kernel, sha256

    return {"gf_apply": gf_kernel.LAUNCHES,
            "gf_apply_packed": gf_kernel.PACKED_LAUNCHES,
            "gf_acc": gf_kernel.ACC_LAUNCHES,
            "gf_acc_pack": gf_kernel.REDUCE_PACK_LAUNCHES,
            "sha256_rows": sha256.LAUNCHES}


def active_sanitizer():
    """The runtime sanitizer this process installed, or None (reached
    through ``sys.modules``, as the port's hooks reach it)."""
    mod = sys.modules.get("chunky_bits_tpu_torch.analysis.sanitizer")
    return mod.active() if mod is not None else None


def sanitizer_steps(blob: bytes, root: str, backend: str, path, rec,
                    workdir: str, tag: str) -> dict:
    """The sanitizer group's four steps, each a path ``san_<tag>_<step>``
    of its own: (1) config 2's ~1 GiB ingest through ``FileWriteBuilder``
    and a ``HostPipeline`` to the void destination, a sample of parts
    held against numpy and hashlib; (2) the same stream written to d+p
    ``path`` destinations under ``root``, the chunk files of shards 0, 1,
    12 and 13 of every part deleted, and read back byte for byte; (3)
    ``gateway.serve`` on a thread at config 19's geometry with QoS on:
    a PUT, ``SAN_GW_SECONDS`` of the config-19 flood, one Range GET and
    one ``If-None-Match`` GET -> 304; (4) ``az_outage`` at N=100, seed 0,
    in ``workdir``, every verdict true.  Returns per step its wall
    seconds, the handoff submits the sanitizer recorded (None when it is
    off), its expected launches and the scenario's trace."""
    import shutil

    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.file import (FileReadBuilder,
                                            LocationsDestination)
    from chunky_bits_tpu_torch.gateway import serve
    from chunky_bits_tpu_torch.ops.batching import (EncodeHashBatcher,
                                                    ReconstructBatcher)
    from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
    from chunky_bits_tpu_torch.sim.scenario import (fresh_workdir,
                                                    run_scenario)
    from chunky_bits_tpu_torch.utils.yamlio import yaml_load

    total = SAN_PARTS * D * CHUNK + TAIL
    out = {}

    def step(name: str, fn):
        san = active_sanitizer()
        before = san.handoff.submits if san is not None else 0
        t0 = time.perf_counter()
        got = path(f"san_{tag}_{name}", fn)
        seconds = time.perf_counter() - t0
        out[name] = {
            "seconds": seconds,
            "submits": (san.handoff.submits - before
                        if san is not None else None),
            "expected": rec.expected()}
        log(f"  sanitizer {tag} {name}: {seconds:.2f} s"
            + (f", {out[name]['submits']} handoff submits"
               if san is not None else ""))
        return got

    # (1) config 2's ingest to the void destination, after a warm-up
    # outside the paths (the child's first launch creates its CUDA context)
    pipeline = HostPipeline()
    phase_object_ingest_warm(blob, pipeline)
    rec.expected()  # drops the warm-up's dispatches
    ref, _batcher = step("ingest", lambda: phase_object_ingest(
        blob, pipeline, f"sanitizer {tag}", CONFIG2, SAN_PARTS,
        backend=backend))
    check_object_ref(ref, blob, CONFIG2, SAN_PARTS, sample=2)

    # (2) on disk, 4 shards of every part lost, read back
    def degraded_read():
        dirs = [os.path.join(root, "disk", f"d{i}") for i in range(D + P)]
        for d in dirs:
            os.makedirs(d)

        async def write():
            batcher = EncodeHashBatcher(backend=backend,
                                        max_batch=OBJECT_BATCH,
                                        host_pipeline=pipeline)
            try:
                return await object_builder(
                    LocationsDestination(dirs), batcher, pipeline,
                    backend=backend).write(CyclicSource(blob, total))
            finally:
                await batcher.aclose()

        async def read(ref):
            batcher = ReconstructBatcher(backend=backend)
            try:
                await read_and_compare(
                    FileReadBuilder(ref).with_backend(backend)
                    .with_batcher(batcher), blob, total)
            finally:
                await batcher.aclose()

        ref = asyncio.run(write())
        for part in ref.parts:
            chunks = part.data + part.parity
            for i in LOST:
                os.remove(str(chunks[i].locations[0]))
        t0 = time.perf_counter()
        asyncio.run(read(ref))
        dt = time.perf_counter() - t0
        log(f"  sanitizer {tag}: {total / 2**30:.3f} GiB read back with "
            f"shards {LOST} of every part lost in {dt:.2f} s, equal to "
            f"the source")
        shutil.rmtree(os.path.join(root, "disk"))

    step("degraded_read", degraded_read)
    pipeline.close()

    # (3) the gateway at config 19's geometry, QoS on
    top = os.path.join(root, "c19")
    os.makedirs(top)
    conf = cluster_yaml(top, CONFIG9, backend, cache_bytes=C19_CACHE,
                        extra={"qos": {"enabled": True, "tenants": {
                            "victim": {"weight": 4,
                                       "keys": [C19_VICTIM_KEY]}}}})
    payload = np.random.default_rng(SEED + 12).integers(
        0, 256, C19_OBJECT, dtype=np.uint8).tobytes()

    def gateway():
        with open(conf) as f:
            cluster = Cluster.from_obj(yaml_load(f.read()))
        gw = ServerThread(lambda on_ready: serve(
            cluster, "127.0.0.1", 0, max_concurrent_gets=C19_CAP,
            on_ready=on_ready), f"gateway-{tag}")
        try:
            status, _h, resp = http_request(
                gw.port, "PUT", "/obj", body_parts=(payload,),
                body_len=len(payload))
            resp.read()
            assert status == 200, status
            got = asyncio.run(c19_flood(gw.port, payload, SAN_GW_SECONDS))
            lo, hi = SAN_RANGE
            status, headers, resp = http_request(
                gw.port, "GET", "/obj", {"Range": f"bytes={lo}-{hi}"})
            assert status == 206, status
            assert resp.read() == payload[lo:hi + 1], "range body differs"
            status, headers, resp = http_request(gw.port, "GET", "/obj")
            assert status == 200 and resp.read() == payload
            status, _h, resp = http_request(
                gw.port, "GET", "/obj", {"If-None-Match": headers["etag"]})
            assert status == 304 and resp.read() == b"", status
        finally:
            gw.stop()
        log(f"  sanitizer {tag} gateway: config 19 QoS on for "
            f"{SAN_GW_SECONDS:.0f} s: {got['ok']} bodies, "
            f"{got['rps']:.1f} requests/s, victim p99 "
            f"{got['victim_p99_ms']:.2f} ms over {got['victim_reads']} "
            f"reads, {got['sheds']} sheds ({got['victim_sheds']} of the "
            f"victim); a Range GET (206) and a 304, every body equal to "
            f"its source")

    step("gateway", gateway)

    # (4) the scenario, in the simulator group's workdir path
    def scenario():
        result = run_scenario("az_outage", nodes=SIM_NODES, seed=SIM_SEED,
                              workdir=fresh_workdir(workdir))
        assert result.ok(), [k for k, v in result.verdicts.items() if not v]
        return result

    result = step("scenario", scenario)
    out["scenario"]["trace"] = result.trace
    shutil.rmtree(workdir, ignore_errors=True)
    for name in SAN_STEPS:
        assert out[name]["expected"]["gf_apply"] > 0, (name, out[name])
    return out


def sanitizer_worker(argv: list[str]) -> int:
    """The sanitizer group's child (``--sanitizer-worker OUT WORKDIR
    BACKEND``), started with ``CHUNKY_BITS_TORCH_SANITIZE=1``: its first
    ``HostPipeline`` installs the runtime sanitizer, whose policy then
    instruments every event loop it makes, ``serve`` its serving loop and
    ``sim.run`` the virtual one.  Runs ``sanitizer_steps`` on ``BACKEND``
    with each step's launch counts set to 0 before it, then writes the
    counts, the expected launches, the seconds, the submits, the
    sanitizer's report and the scenario's trace under ``OUT``; exits 1
    unless the report is clean and every step recorded a submit."""
    import shutil
    import tempfile

    from chunky_bits_tpu_torch.cluster.tunables import sanitize_enabled
    from chunky_bits_tpu_torch.ops.backend import get_coder

    out_dir, workdir, backend = argv
    assert sanitize_enabled(), "the worker runs with the sanitizer on"
    be = get_coder(D, P, backend).backend
    rec = ApplyRecorder(be)
    counts = {}

    def path(name: str, fn):
        zero_counts()
        got = fn()
        counts[name] = read_counts()
        return got

    blob = np.random.default_rng(SEED + 4).integers(
        0, 256, BLOB_BYTES, dtype=np.uint8).tobytes()
    root = tempfile.mkdtemp(prefix="cb_san_")
    try:
        steps = sanitizer_steps(blob, root, backend, path, rec, workdir,
                                "on")
    finally:
        rec.close()
        shutil.rmtree(root, ignore_errors=True)
    from chunky_bits_tpu_torch.analysis import sanitizer

    report = sanitizer.report()
    log(report.render())
    with open(os.path.join(out_dir, "trace"), "wb") as f:
        f.write(steps["scenario"].pop("trace"))
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({"counts": counts, "steps": steps, "ok": report.ok(),
                   "stalls": report.stalls, "report": report.render()}, f)
    missing = [n for n in SAN_STEPS if not steps[n]["submits"]]
    return 0 if report.ok() and not missing else 1


def phase_sanitizer(blob: bytes, path, counts, be, tp_rec, sim_off: dict,
                    smi: str) -> dict:
    """The sanitizer group: the four ``sanitizer_steps`` with the runtime
    concurrency sanitizer off, in this process, and on, in a child
    (``--sanitizer-worker``, since ``install`` swaps the process-wide
    loop policy) on ``cuda`` with ``CHUNKY_BITS_TORCH_SANITIZE=1``.  The
    child's report must be clean (0 leaked tasks, 0 unretrieved
    exceptions, 0 handoff violations), every step must record a handoff
    submit and launch K1 as its recorded dispatches call for, and the
    scenario's trace must equal the simulator group's sanitize-off run
    byte for byte.  Stalls stay advisory and are printed, with each
    step's wall seconds off and on.  Returns the expected launches of its
    paths, the child's among them."""
    import shutil
    import tempfile

    from chunky_bits_tpu_torch.cluster.tunables import (SANITIZE_ENV,
                                                        environ_without)

    expected = {}
    rec = ApplyRecorder(be)
    t_group = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cb_san_")
    try:
        off = sanitizer_steps(blob, root, be.name, path, rec,
                              sim_off["workdir"], "off")
    finally:
        rec.close()
        shutil.rmtree(root, ignore_errors=True)
    assert off["scenario"]["trace"] == sim_off["trace"], (
        "az_outage trace differs from the simulator group's: "
        + first_trace_difference(sim_off["trace"], off["scenario"]["trace"]))
    for name in SAN_STEPS:
        want, mesh = off[name]["expected"], tp_rec.expected()
        expected[f"san_off_{name}"] = {k: want[k] + mesh[k] for k in KERNELS}

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="cb_san_out_") as out_dir:
        env = dict(environ_without(SANITIZE_ENV), **{SANITIZE_ENV: "1"})
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--sanitizer-worker", out_dir, sim_off["workdir"], be.name],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"  | {line}")
        assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
        with open(os.path.join(out_dir, "result.json")) as f:
            on = json.load(f)
        with open(os.path.join(out_dir, "trace"), "rb") as f:
            trace = f.read()
    assert on["ok"], on["report"]
    assert trace == sim_off["trace"], (
        "sanitized az_outage trace differs from the sanitize-off run: "
        + first_trace_difference(sim_off["trace"], trace))
    for name in SAN_STEPS:
        step = on["steps"][name]
        assert step["submits"] >= 1, (name, step)
        tag = f"san_on_{name}"
        counts[tag] = on["counts"][tag]
        expected[tag] = step["expected"]
        assert counts[tag]["gf_apply"] > 0, (tag, counts[tag])
    log(f"sanitizer group on {be.name} ({smi}): report clean (0 leaked "
        f"tasks, 0 unretrieved exceptions, 0 handoff violations); "
        f"{len(on['stalls'])} loop stall(s), advisory"
        + "".join(f"\n  STALL: {s}" for s in on["stalls"]))
    for name in SAN_STEPS:
        off_s = off[name]["seconds"]
        step = on["steps"][name]
        log(f"  {name}: wall {off_s:.2f} s sanitizer off, "
            f"{step['seconds']:.2f} s on ({step['seconds'] / off_s:.3f}x); "
            f"{step['submits']} handoff submits; K1 launches "
            f"{counts['san_on_' + name]['gf_apply']} on, "
            f"{counts['san_off_' + name]['gf_apply']} off")
    log(f"  az_outage at N={SIM_NODES}, seed {SIM_SEED}: sanitized trace "
        f"byte-identical to the sanitize-off run ({len(trace)} bytes); "
        f"the child took {child_s:.1f} s")
    phase_lint(here)
    log(f"sanitizer group: {time.perf_counter() - t_group:.1f} s")
    return expected


#: the linter's families, each timed alone by the lint step
LINT_FAMILIES = ("CB1", "CB2", "CB3", "CB4")


def phase_lint(here: str) -> None:
    """``python -m chunky_bits_tpu_torch.analysis --json --graph-stats``
    over the port on the card's box: exit 0, 0 new findings, 0 baselined
    and 0 stale; then each family alone (``--select CBn``), timed."""
    def lint(*args) -> tuple[dict, float]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "chunky_bits_tpu_torch.analysis",
             "--json", *args], cwd=here, capture_output=True, text=True,
            timeout=300)
        seconds = time.perf_counter() - t0
        assert proc.returncode == 0, (args, proc.stdout[-4000:],
                                      proc.stderr[-4000:])
        return json.loads(proc.stdout), seconds

    report, seconds = lint("--graph-stats")
    assert report["ok"] and report["new"] == [] and not report["errors"]
    assert report["baselined"] == 0 and report["stale_baseline_entries"] \
        == 0, report
    graph = report["graph"]
    log(f"lint: python -m chunky_bits_tpu_torch.analysis --json "
        f"--graph-stats: rc 0, 0 new, 0 baselined, 0 stale, {seconds:.2f} s"
        f"; graph {graph['functions']} functions, {graph['edges']} edges, "
        f"{graph['worker_roots']} worker roots; cfg "
        f"{graph['cfg_functions']} functions, {graph['cfg_blocks']} blocks")
    for family in LINT_FAMILIES:
        report, seconds = lint("--select", family)
        assert report["new"] == [], (family, report["new"])
        log(f"  lint {family}xx alone: {seconds:.2f} s, 0 new")


# ---- the baseline_ab group: the JAX package's A/Bs on the card ----

#: config 4 (bench.py:1574-1656): 4 MiB objects as [1, 8, 512 KiB], d=8
#: p=3, 16 in flight through one EncodeHashBatcher; bench.py runs 96
AB4_GEO = Geometry(8, 3, 512 << 10, ())
AB4_OBJECTS = 1024
AB4_INFLIGHT = 16
#: configs 6 and 7: the reference's default geometry, d=3 p=2, 1 MiB
AB_D3P2 = Geometry(3, 2, 1 << 20, ())
AB6_BYTES = 64 << 20      # config 6 (bench.py:707-804): one object,
AB6_READS = 5             # 5 timed reads a leg
AB7_BYTES = 512 << 20     # config 7 (bench.py:805-927): a 512 MiB body
AB7_TRIALS = 2            # (bench.py: 1 GiB), best of 2 (bench.py: 3),
                          # at host_threads 1 and 2: both cut for the
                          # script's time
AB7_THREADS = (1, 2)
#: config 8 (bench.py:928-1173): 4 parts of 32 KiB chunks on five nodes,
#: node 0 slow, 40 passes a leg, hedge floor 10 ms on the ON leg
AB8_GEO = Geometry(3, 2, 32 << 10, ())
AB8_PARTS = 4
AB8_READS = 40
AB8_DELAY_S = 0.1
AB8_HEDGE_MS = 10.0
#: config 10 (bench.py:1658-1819): 150 objects of 16 KiB, 4 KiB chunks
AB10_GEO = Geometry(3, 2, 4 << 10, ())
AB10_OBJECTS = 150
AB10_OBJ = 16 << 10
#: config 18 (bench.py:1820-2135): refs in 32 x 16 directories, cut to
#: 2,500 of bench.py's 10,000 for the script's time
AB18_OBJECTS = 2_500
#: config 17 (bench.py:3334-3542): d=10 p=4, 256 KiB, 16 parts x 4
#: batches, best of 3 iterations, over 8 logical devices
AB17_GEO = Geometry(10, 4, 256 << 10, ())
AB17_PARTS = 16
AB17_BATCHES = 4
AB17_ITERS = 3


def ab_objects(blob: bytes, n: int, geo: Geometry) -> list[np.ndarray]:
    """``n`` distinct windows of ``geo.d * geo.chunk`` bytes of ``blob``
    at staggered offsets, each a ``[1, d, chunk]`` view (no copy)."""
    buf = np.frombuffer(blob, dtype=np.uint8)
    size = geo.d * geo.chunk
    stride = (len(buf) - size) // max(1, n - 1)
    assert stride > 0, "the blob is too short for distinct windows"
    return [buf[i * stride:i * stride + size].reshape(1, geo.d, geo.chunk)
            for i in range(n)]


def expected_fused(backend, shapes) -> dict:
    """Launches the device-SHA route of ``encode_and_hash`` calls for on
    dispatches of ``shapes``: a K1 and a SHA kernel per block of the fused
    walk."""
    want = {name: 0 for name in KERNELS}
    for b, r, k, s in shapes:
        blocks = walk_blocks(backend, "max_fused_block_bytes", b,
                             (k + r) * s)
        want["gf_apply"] += blocks
        want["sha256_rows"] += blocks
    return want


def ref_layout(ref) -> dict:
    """A file reference without its chunk locations: what two clusters
    over different directories must agree on."""
    obj = ref.to_obj()
    for part in obj["parts"]:
        for chunk in part["data"] + part.get("parity", []):
            chunk.pop("locations", None)
    return obj


def ab_cluster(root: str, geo: Geometry, backend: str, **kwargs):
    """A ``Cluster`` over ``cluster_yaml(root, geo, backend, **kwargs)``."""
    import yaml

    from chunky_bits_tpu_torch.cluster import Cluster

    with open(cluster_yaml(root, geo, backend, **kwargs)) as f:
        return Cluster.from_obj(yaml.safe_load(f))


class LoopSteps:
    """One event loop that lives across counted steps: ``path(name,
    steps.run, coro)`` runs ``coro`` on it, so per-loop state (the
    cluster's batchers and chunk cache, an aiohttp session) carries from
    one step to the next."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()

    def run(self, coro):
        return self.loop.run_until_complete(coro)

    def close(self) -> None:
        self.loop.run_until_complete(self.loop.shutdown_asyncgens())
        self.loop.close()


def ab_config4(blob: bytes, path, be, objects: int = AB4_OBJECTS,
               geo: Geometry = AB4_GEO, inflight: int = AB4_INFLIGHT,
               oracle=None) -> dict:
    """BASELINE config 4's encode+hash core: ``objects`` small objects,
    ``inflight`` at a time, through one ``EncodeHashBatcher`` on ``be``,
    with host SHA and then the SHA kernel (``be.device_sha``).  Every
    object's parity equals the ``oracle`` backend's (the port's numpy
    backend when None) and its d+p digests hashlib's on both legs; the
    merging backend makes a group one dispatch."""
    from chunky_bits_tpu_torch.ops import matrix
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    encode_cls, _ = recording_batchers()
    objs = ab_objects(blob, objects, geo)
    nbytes = (objects - 1) * geo.d * geo.chunk

    def leg(device_sha: bool):
        async def drive():
            batcher = encode_cls(backend=be.name)
            sem = asyncio.Semaphore(inflight)

            async def one(obj):
                async with sem:
                    return await batcher.encode_hash(geo.d, geo.p, obj)

            outs = [await one(objs[0])]  # the warm-up, as bench.py's
            t0 = time.perf_counter()
            outs += await asyncio.gather(*(one(o) for o in objs[1:]))
            dt = time.perf_counter() - t0
            await batcher.aclose()
            return outs, batcher, dt

        had = "device_sha" in vars(be)
        saved = getattr(be, "device_sha", None)
        be.device_sha = device_sha
        try:
            return asyncio.run(drive())
        finally:
            if had:
                be.device_sha = saved
            else:
                del be.device_sha

    expected, legs = {}, {}
    for device_sha in (False, True):
        name = "ab4_" + ("device_sha" if device_sha else "host_sha")
        outs, batcher, dt = path(name, leg, device_sha)
        expected[name] = (expected_fused(be, batcher.shapes) if device_sha
                          else expected_gf(be, batcher.shapes, False))
        assert expected[name]["gf_apply"] == batcher.dispatches, (
            expected[name], batcher.dispatches)
        legs[name] = {"outs": outs, "gib_s": gib_s(nbytes, dt),
                      "dispatches": batcher.dispatches,
                      "groups": batcher.groups,
                      "shapes": list(batcher.shapes),
                      "per_group": (objects - 1) / max(batcher.groups - 1,
                                                       1)}
    host, dev = legs["ab4_host_sha"]["outs"], legs["ab4_device_sha"]["outs"]
    rows_of = matrix.build_encode_matrix(geo.d, geo.p)[geo.d:]
    oracle = oracle or NumpyBackend()

    def check(i: int) -> None:
        parity = oracle.apply_matrix(rows_of, objs[i])
        assert np.array_equal(host[i][0], parity), f"object {i}: parity"
        assert np.array_equal(dev[i][0], parity), f"object {i}: parity"
        rows = np.concatenate([objs[i], parity], axis=1)[0]
        want = b"".join(hashlib.sha256(r).digest() for r in rows)
        assert host[i][1].tobytes() == want, f"object {i}: digests"
        assert dev[i][1].tobytes() == want, f"object {i}: digests"

    with ThreadPoolExecutor() as pool:
        list(pool.map(check, range(objects)))
    ratio = legs["ab4_device_sha"]["gib_s"] / legs["ab4_host_sha"]["gib_s"]
    for name, leg_ in legs.items():
        log(f"  config 4 {name}: {objects} objects of [1, {geo.d}, "
            f"{geo.chunk >> 10} KiB], {inflight} in flight: "
            f"{leg_['gib_s']:.3f} GiB/s; {leg_['per_group']:.1f} objects a "
            f"group, {leg_['dispatches']} dispatches, launches "
            f"{expected[name]}")
    log(f"  config 4: parity of all {objects} objects equal to numpy and "
        f"their {objects * (geo.d + geo.p)} digests to hashlib on both "
        f"legs; device SHA / host SHA {ratio:.3f}")
    return {"expected": expected, "legs": legs, "ratio": ratio}


def ab_config6(root: str, blob: bytes, path, be, rec,
               nbytes: int = AB6_BYTES, reads: int = AB6_READS,
               geo: Geometry = AB_D3P2) -> dict:
    """BASELINE config 6, the hot-read cache A/B: one object on five
    ``path`` destinations read through ``Cluster.file_read_builder``,
    ``reads`` timed reads with ``cache_bytes`` 0 and then on.  Off: no
    cache exists.  On: after the first read every data chunk hits (a
    rebuilt one was inserted too), so the timed reads fetch and decode
    nothing."""
    from chunky_bits_tpu_torch.utils import aio

    payload = source_slice(blob, 0, nbytes)
    expected, out = {}, {"refs": []}
    for leg, cache_bytes in (("off", 0), ("on", max(4 * nbytes, 64 << 20))):
        top = os.path.join(root, f"ab6_{leg}")
        cluster = ab_cluster(top, geo, be.name, cache_bytes=cache_bytes)
        steps = LoopSteps()
        tag = f"ab6_{leg}"

        async def write():
            return await cluster.write_file(
                "obj", aio.BytesReader(payload), cluster.get_profile(None))

        async def warm():
            ref = await cluster.get_file_ref("obj")
            got = await cluster.file_read_builder(ref).read_all()
            assert got == payload, f"config 6 {leg}: first read differs"
            return cluster._chunk_cache(), cluster._reconstruct_batcher()

        async def timed():
            best, bodies = float("inf"), []
            for _ in range(reads):
                pieces = []
                t0 = time.perf_counter()
                ref = await cluster.get_file_ref("obj")
                async for chunk in cluster.file_read_builder(ref).stream():
                    pieces.append(chunk)
                best = min(best, time.perf_counter() - t0)
                bodies.append(pieces)
            for pieces in bodies:
                assert b"".join(pieces) == payload, \
                    f"config 6 {leg}: a timed read differs"
            return best

        try:
            rec.expected()
            ref = path(tag + "_write", steps.run, write())
            expected[tag + "_write"] = rec.expected()
            cache, batcher = path(tag + "_warm", steps.run, warm())
            expected[tag + "_warm"] = rec.expected()
            assert expected[tag + "_warm"]["gf_apply"] == batcher.dispatches
            before = (cache.stats() if cache is not None else None,
                      batcher.dispatches)
            best = path(tag + "_reads", steps.run, timed())
            expected[tag + "_reads"] = rec.expected()
            dispatches = batcher.dispatches - before[1]
            assert expected[tag + "_reads"]["gf_apply"] == dispatches
            steps.run(cluster.tunables.location_context().aclose())
        finally:
            steps.close()
        if cache is None:
            assert cache_bytes == 0
            hits = misses = 0
        else:
            # every data chunk was cached by the first read (fetched and
            # verified, or rebuilt and inserted), and so was each parity
            # chunk it fetched: a timed read looks each of them up once
            cached = [chunk.cache_key() for part in ref.parts
                      for chunk in part.data + part.parity
                      if cache.contains(chunk.cache_key())]
            assert all(cache.contains(chunk.cache_key())
                       for part in ref.parts for chunk in part.data)
            after = cache.stats()
            hits = after.hits - before[0].hits
            misses = after.misses - before[0].misses
            assert (hits, misses) == (reads * len(cached), 0), (hits, misses)
            assert dispatches == 0, "a cached read decoded"
        out[leg] = {"gib_s": gib_s(nbytes, best), "hits": hits,
                    "misses": misses, "warm_dispatches": before[1],
                    "read_dispatches": dispatches}
        out["refs"].append(ref_layout(ref))
        log(f"  config 6 cache {leg}: {reads} reads of {nbytes >> 20} MiB, "
            f"best {gib_s(nbytes, best):.3f} GiB/s; cache hits {hits}, "
            f"misses {misses} in the timed reads; decode dispatches: "
            f"first read {before[1]}, timed reads {dispatches}")
    assert out["refs"][0] == out["refs"][1], "config 6: references differ"
    out["speedup"] = out["on"]["gib_s"] / out["off"]["gib_s"]
    log(f"  config 6: every read equal to the source; cached / uncached "
        f"{out['speedup']:.2f}x")
    return {"expected": expected, **out}


def ab_config7(root: str, blob: bytes, path, be, rec,
               nbytes: int = AB7_BYTES, trials: int = AB7_TRIALS,
               threads=AB7_THREADS, geo: Geometry = AB_D3P2) -> dict:
    """BASELINE config 7, gateway PUT ingest: a body of ``nbytes``
    streamed through ``make_app`` on an aiohttp test server, best of
    ``trials``, once at each ``tunables.host_threads`` of ``threads``;
    the clients share the server's event loop, as in bench.py.  Each
    stored object reads back equal to the body over GET, and the file
    references of every trial and leg are equal."""
    from aiohttp import ClientSession, ClientTimeout
    from aiohttp.test_utils import TestServer

    from chunky_bits_tpu_torch.gateway.http import make_app

    piece = 8 << 20
    want = hashlib.sha256()
    for lo in range(0, nbytes, piece):
        want.update(source_slice(blob, lo, min(piece, nbytes - lo)))
    want = want.digest()

    async def body():
        for lo in range(0, nbytes, piece):
            yield source_slice(blob, lo, min(piece, nbytes - lo))

    expected, out = {}, {"refs": []}
    for n in threads:
        top = os.path.join(root, f"ab7_host{n}")
        cluster = ab_cluster(top, geo, be.name, extra={"host_threads": n})
        steps = LoopSteps()
        tag = f"ab7_host{n}"

        async def start():
            server = TestServer(make_app(cluster))
            await server.start_server()
            session = ClientSession(timeout=ClientTimeout(total=3600))
            # warm: the thread pools and the first dispatch
            resp = await session.put(server.make_url("/warm"),
                                     data=source_slice(blob, 0, 1 << 20))
            assert resp.status == 200, resp.status
            resp.release()
            return server, session

        async def puts():
            best = float("inf")
            for t in range(trials):
                t0 = time.perf_counter()
                resp = await session.put(server.make_url(f"/obj{t}"),
                                         data=body())
                dt = time.perf_counter() - t0
                assert resp.status == 200, resp.status
                resp.release()
                best = min(best, dt)
            return best

        async def gets():
            for t in range(trials):
                resp = await session.get(server.make_url(f"/obj{t}"))
                assert resp.status == 200, resp.status
                got, digest = 0, hashlib.sha256()
                async for chunk in resp.content.iter_chunked(piece):
                    digest.update(chunk)
                    got += len(chunk)
                resp.release()
                assert (got, digest.digest()) == (nbytes, want), \
                    f"config 7 host_threads={n}: GET obj{t} differs"
            return [ref_layout(await cluster.get_file_ref(f"obj{t}"))
                    for t in range(trials)]

        try:
            server, session = steps.run(start())
            try:
                rec.expected()
                best = path(tag + "_put", steps.run, puts())
                expected[tag + "_put"] = rec.expected()
                refs = path(tag + "_get", steps.run, gets())
                expected[tag + "_get"] = rec.expected()
            finally:
                steps.run(session.close())
                steps.run(server.close())
                steps.run(cluster.tunables.location_context().aclose())
                cluster.host_pipeline().close()
        finally:
            steps.close()
        assert all(r == refs[0] for r in refs), "config 7: trials differ"
        out["refs"].append(refs[0])
        out[n] = gib_s(nbytes, best)
        log(f"  config 7 host_threads={n}: PUT of {nbytes / 2**30:.3f} GiB, "
            f"best of {trials}: {out[n]:.3f} GiB/s (the clients share the "
            f"server's interpreter); K1 launches: PUTs "
            f"{expected[tag + '_put']['gf_apply']}, GETs "
            f"{expected[tag + '_get']['gf_apply']}")
    assert all(r == out["refs"][0] for r in out["refs"]), \
        "config 7: references differ between legs"
    log(f"  config 7: every GET equal to the body; references equal "
        f"across {len(threads)} legs x {trials} trials")
    return {"expected": expected, **out}


def ab_config8(root: str, blob: bytes, path, be, rec,
               parts: int = AB8_PARTS, geo: Geometry = AB8_GEO,
               reads: int = AB8_READS, delay_s: float = AB8_DELAY_S,
               hedge_ms: float = AB8_HEDGE_MS) -> dict:
    """BASELINE config 8, the hedged-read tail A/B: an object of
    ``parts`` parts on five ``ChunkNode`` servers, every chunk with a
    second replica on a fast node, node 0's GETs delayed ``delay_s``
    +-25%; ``reads`` passes over the parts with ``hedge_ms`` 0 and then
    ``hedge_ms``.  Every read equals the source, the off leg hedges
    never, the on leg within the scoreboard's budget, and the on leg's
    p99 is below the off leg's."""
    from urllib.parse import urlparse

    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.file.location import Location
    from chunky_bits_tpu_torch.utils import aio

    part_bytes = geo.d * geo.chunk
    payload = source_slice(blob, 0, parts * part_bytes)
    nodes = [ChunkNode(os.path.join(root, f"ab8_n{i}"), seed=SEED + i)
             for i in range(geo.d + geo.p)]
    servers = []
    meta = os.path.join(root, "ab8_meta")
    os.makedirs(meta)
    for node in nodes:
        os.makedirs(node.root)
    expected, out = {}, {}
    try:
        for i, node in enumerate(nodes):
            servers.append(ServerThread(node.serve, f"config-8 node {i}"))
        urls = [f"http://127.0.0.1:{s.port}/" for s in servers]

        def make(hedge: float):
            return Cluster.from_obj({
                "destinations": [{"location": u} for u in urls],
                "metadata": {"type": "path", "format": "yaml",
                             "path": meta},
                "profiles": {"default": {
                    "data": geo.d, "parity": geo.p,
                    "chunk_size": geo.chunk.bit_length() - 1}},
                "tunables": {"backend": be.name, "hedge_ms": hedge}})

        async def write():
            cluster = make(0)
            await cluster.write_file("obj", aio.BytesReader(payload),
                                     cluster.get_profile(None))
            ref = await cluster.get_file_ref("obj")
            await cluster.tunables.location_context().aclose()
            return ref

        rec.expected()
        ref = path("ab8_write", asyncio.run, write())
        expected["ab8_write"] = rec.expected()
        # a second replica of every chunk on a fast node (never node 0:
        # one slow replica per chunk is the scenario)
        fast = 1
        for part in ref.parts:
            for chunk in part.data + part.parity:
                url = str(chunk.locations[0])
                owner = next(i for i, u in enumerate(urls)
                             if url.startswith(u))
                while fast in (0, owner):
                    fast = (fast + 1) % len(nodes)
                key = urlparse(url).path
                with open(nodes[owner].file(key), "rb") as f:
                    raw = f.read()
                with open(nodes[fast].file(key), "wb") as f:
                    f.write(raw)
                chunk.locations.append(Location.http(
                    urls[fast] + key.lstrip("/")))
                fast = (fast + 1) % len(nodes)
        nodes[0].delay_s = delay_s

        for hedge in (0.0, hedge_ms):
            cluster = make(hedge)
            cx = cluster.tunables.location_context()
            tag = f"ab8_hedge{hedge:g}"
            steps = LoopSteps()

            async def warm():
                for part in ref.parts:
                    await part.read(cx, backend=be.name)

            async def timed():
                for node in nodes:
                    node.gets = 0
                lat = []
                for _ in range(reads):
                    for i, part in enumerate(ref.parts):
                        t0 = time.perf_counter()
                        bufs = await part.read_buffers(cx, backend=be.name)
                        lat.append(time.perf_counter() - t0)
                        got = b"".join(bytes(b) for b in bufs)
                        assert got == payload[i * part_bytes:
                                              (i + 1) * part_bytes], \
                            f"config 8 {tag}: part {i} differs"
                requests = sum(node.gets for node in nodes)
                got = await cluster.file_read_builder(ref).read_all()
                assert got == payload, f"config 8 {tag}: the object differs"
                return lat, requests

            try:
                steps.run(warm())
                rec.expected()
                warm_fired = cluster.health_scoreboard().hedges_fired
                lat, requests = path(tag, steps.run, timed())
                expected[tag] = rec.expected()
                steps.run(cx.aclose())
            finally:
                steps.close()
            board = cluster.health_scoreboard()
            st = board.stats()
            budget = board.hedge_ratio * st.primaries + board.hedge_burst
            arr = np.array(lat)
            out[tag] = {
                "p50_ms": float(np.percentile(arr, 50)) * 1e3,
                "p99_ms": float(np.percentile(arr, 99)) * 1e3,
                "gib_s": gib_s(reads * len(payload), float(arr.sum())),
                "requests": requests, "hedges_fired": st.hedges_fired,
                "timed_hedges": st.hedges_fired - warm_fired,
                "hedges_won": st.hedges_won,
                "hedges_cancelled": st.hedges_cancelled,
                "primaries": st.primaries, "budget": budget}
            if hedge == 0:
                assert st.hedges_fired == 0, "config 8: the off leg hedged"
            else:
                assert st.hedges_fired <= budget, (st.hedges_fired, budget)
            r = out[tag]
            log(f"  config 8 hedge_ms={hedge:g}: {reads} passes of {parts} "
                f"parts, p50 {r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, "
                f"{r['gib_s']:.4f} GiB/s, {requests} GETs, hedges fired/won/"
                f"cancelled {st.hedges_fired}/{st.hedges_won}/"
                f"{st.hedges_cancelled} ({r['timed_hedges']} of them in the "
                f"timed passes; budget {budget:.2f} of "
                f"{st.primaries} primaries), K1 launches "
                f"{expected[tag]['gf_apply']}")
    finally:
        for server in servers:
            server.stop()
    off, on = out["ab8_hedge0"], out[f"ab8_hedge{hedge_ms:g}"]
    out["off"], out["on"] = off, on
    out["collapse"] = off["p99_ms"] / on["p99_ms"]
    out["amplification"] = on["requests"] / off["requests"] - 1.0
    assert on["p99_ms"] < off["p99_ms"], (on["p99_ms"], off["p99_ms"])
    log(f"  config 8: every read equal to the source; p99 collapse "
        f"{out['collapse']:.2f}x, amplification "
        f"{out['amplification'] * 100:.1f}%")
    return {"expected": expected, **out}


def gc_candidates(root: str, dirs: int, slab: bool) -> set:
    """The GC candidate enumeration of bench.py's config 10 over the
    destinations ``root``/d0..: one index scan a slab store, or every
    chunk file listed and stat'ed (find-unused-hashes' grace-age check on
    ``path`` destinations).  Returns the chunk names."""
    from chunky_bits_tpu_torch.file import slab as slab_mod

    names = set()
    for i in range(dirs):
        top = os.path.join(root, f"d{i}")
        if slab:
            names.update(slab_mod.get_store(top).live_names())
            continue
        for dirpath, _dirs, files in os.walk(top):
            for name in files:
                os.stat(os.path.join(dirpath, name))
                names.add(name)
    return names


def ab_config10(root: str, blob: bytes, path, be, rec,
                objects: int = AB10_OBJECTS, obj_bytes: int = AB10_OBJ,
                geo: Geometry = AB10_GEO) -> dict:
    """BASELINE config 10, slab store vs file-per-chunk: ``objects``
    objects of ``obj_bytes`` written and read through a ``path`` cluster
    and a ``slab:`` one, then each layout's GC candidate enumeration
    timed.  Reads equal the sources in both; the candidate sets are
    equal."""
    from chunky_bits_tpu_torch.utils import aio

    payloads = [source_slice(blob, i * obj_bytes, obj_bytes)
                for i in range(objects)]
    expected, out = {}, {}
    for layout, slabs in (("files", 0), ("slab", geo.d + geo.p)):
        top = os.path.join(root, f"ab10_{layout}")
        cluster = ab_cluster(top, geo, be.name, slabs=slabs)
        profile = cluster.get_profile(None)
        steps = LoopSteps()
        tag = f"ab10_{layout}"

        async def puts():
            t0 = time.perf_counter()
            for i, payload in enumerate(payloads):
                await cluster.write_file(f"o{i:04d}",
                                         aio.BytesReader(payload), profile)
            return time.perf_counter() - t0

        async def gets():
            bodies = []
            t0 = time.perf_counter()
            for i in range(objects):
                ref = await cluster.get_file_ref(f"o{i:04d}")
                bodies.append(
                    await cluster.file_read_builder(ref).read_all())
            dt = time.perf_counter() - t0
            for i, body in enumerate(bodies):
                assert body == payloads[i], f"config 10 {layout}: o{i:04d}"
            return dt

        try:
            rec.expected()
            put_s = path(tag + "_put", steps.run, puts())
            expected[tag + "_put"] = rec.expected()
            get_s = path(tag + "_get", steps.run, gets())
            expected[tag + "_get"] = rec.expected()
            steps.run(cluster.tunables.location_context().aclose())
        finally:
            steps.close()
        t0 = time.perf_counter()
        names = gc_candidates(top, geo.d + geo.p, bool(slabs))
        gc_ms = (time.perf_counter() - t0) * 1e3
        out[layout] = {"put_ops": objects / put_s,
                       "get_ops": objects / get_s, "gc_ms": gc_ms,
                       "candidates": names}
        log(f"  config 10 {layout}: PUT {objects / put_s:.1f} objects/s, GET "
            f"{objects / get_s:.1f} objects/s, GC enumeration {gc_ms:.2f} ms "
            f"({len(names)} chunks); K1 launches PUT "
            f"{expected[tag + '_put']['gf_apply']}, GET "
            f"{expected[tag + '_get']['gf_apply']}")
    assert out["files"]["candidates"] == out["slab"]["candidates"], \
        "config 10: the candidate sets differ"
    out["gc_speedup"] = out["files"]["gc_ms"] / out["slab"]["gc_ms"]
    out["get_ab"] = out["slab"]["get_ops"] / out["files"]["get_ops"]
    log(f"  config 10: reads byte-identical in both layouts, candidate "
        f"sets equal; GC walk files / slab {out['gc_speedup']:.2f}x, GET "
        f"slab / files {out['get_ab']:.2f}x")
    return {"expected": expected, **out}


def ab18_name(i: int) -> str:
    return f"ns{i % 32:02d}/g{(i // 32) % 16:02d}/o{i:06d}"


def ab18_ref(i: int) -> dict:
    """bench.py's config-18 reference: one d=3 p=2 part in a real write's
    ``to_obj`` layout, its hashes derived from ``i``."""

    def chunk(j: int) -> dict:
        digest = hashlib.sha256(f"{i}:{j}".encode()).hexdigest()
        return {"sha256": digest, "locations": [f"d{j}/sha256-{digest}"]}

    return {"length": 12_288,
            "parts": [{"chunksize": 4096,
                       "data": [chunk(j) for j in range(3)],
                       "parity": [chunk(j) for j in (3, 4)]}]}


def ab_config18(root: str, objects: int = AB18_OBJECTS,
                stores=None) -> dict:
    """BASELINE config 18, the meta-log's indexed namespace against a
    store of a file per reference: ``objects`` references in 32 x 16
    directories published through ``type: path`` and ``type: meta-log``
    stores, then the recursive list, one prefix scan, the scrub
    pre-scan, the GC liveness walk, ``namespace_snapshot`` and a cold
    index rebuild timed on each, as bench.py times them.  ``stores`` is
    ``(MetadataFormat, MetadataPath, MetadataLog, MetaLogStore)``, the
    port's when None.  Every ~97th reference is byte-identical across
    the stores; the listings and the liveness sets are equal."""
    if stores is None:
        from chunky_bits_tpu_torch.cluster.meta_log import (MetadataLog,
                                                            MetaLogStore)
        from chunky_bits_tpu_torch.cluster.metadata import (MetadataFormat,
                                                            MetadataPath)

        stores = (MetadataFormat, MetadataPath, MetadataLog, MetaLogStore)
    fmt_cls, path_cls, log_cls, log_store_cls = stores
    names = [ab18_name(i) for i in range(objects)]
    refs = [ab18_ref(i) for i in range(objects)]

    async def walk(store, top: str = ".") -> list:
        found, stack = [], [top]
        while stack:
            at = stack.pop()
            for entry in await store.list(at):
                if str(entry.path) in (".", at):
                    continue
                if entry.is_directory():
                    stack.append(entry.path)
                elif entry.is_file():
                    found.append(entry.path)
        return found

    async def leg(kind: str) -> dict:
        meta = os.path.join(root, f"ab18_{kind}")
        os.makedirs(meta)
        fmt = fmt_cls("json-strict")
        store = (path_cls(path=meta, format=fmt) if kind == "path"
                 else log_cls(path=meta, format=fmt))
        t = {}
        t0 = time.perf_counter()
        for name, obj in zip(names, refs):
            await store.write(name, obj)
        t["put_s"] = time.perf_counter() - t0
        recursive = getattr(store, "list_files_recursive", None)
        t0 = time.perf_counter()
        files = await (recursive("") if recursive else walk(store))
        t["list_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        subtree = await (recursive("ns07") if recursive
                         else walk(store, "ns07"))
        t["prefix_ms"] = (time.perf_counter() - t0) * 1e3
        # the scrub pre-scan: one index scan of publish-time node keys
        # (scrub.py's _index_prescan) against the walk that reads and
        # parses every reference (_namespace_refs on a path store)
        index_nodes = getattr(store, "namespace_nodes", None)
        t0 = time.perf_counter()
        if index_nodes is not None:
            rows = await index_nodes()
            assert rows is not None, "the node-key projection is missing"
            scanned = [(2, name) for name, _keys in rows]
        else:
            scanned = [(p, await store.read(p)) for p in await walk(store)]
        t["scrub_ms"] = (time.perf_counter() - t0) * 1e3
        # the GC liveness walk (find-unused-hashes): the index's hash
        # projection against reading every reference
        live = set()
        index_hashes = getattr(store, "namespace_hashes", None)
        t0 = time.perf_counter()
        if index_hashes is not None:
            rows = await index_hashes()
            assert rows is not None, "the hash projection is missing"
            for _name, hashes in rows:
                live.update(hashes)
        else:
            for p in await walk(store):
                for part in (await store.read(p))["parts"]:
                    for chunk in part["data"] + part["parity"]:
                        live.add("sha256-" + chunk["sha256"])
        t["gc_ms"] = (time.perf_counter() - t0) * 1e3
        if kind == "meta-log":
            t0 = time.perf_counter()
            fetched = await store.namespace_snapshot()
            t["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
            assert len(fetched) == objects, len(fetched)
            del fetched
            t0 = time.perf_counter()
            cold = len(log_store_cls(meta).live_names())
            t["cold_ms"] = (time.perf_counter() - t0) * 1e3
            assert cold == objects, cold
        assert len(files) == len(scanned) == objects, (len(files),
                                                       len(scanned))
        assert len(subtree) == sum(1 for n in names
                                   if n.startswith("ns07/")), len(subtree)
        return {"times": t, "files": sorted(str(f) for f in files),
                "subtree": sorted(str(f) for f in subtree), "live": live,
                "meta": meta}

    path_leg = asyncio.run(leg("path"))
    log_leg = asyncio.run(leg("meta-log"))
    log_store = log_store_cls(log_leg["meta"])
    step = max(1, objects // 97)
    compared = 0
    for i in list(range(0, objects, step)) + [objects - 1]:
        with open(os.path.join(path_leg["meta"],
                               *names[i].split("/")), "rb") as f:
            assert f.read() == log_store.read_bytes(names[i]), names[i]
        compared += 1
    assert path_leg["files"] == log_leg["files"], "config 18: listings"
    assert path_leg["subtree"] == log_leg["subtree"], "config 18: prefix"
    assert path_leg["live"] == log_leg["live"], "config 18: liveness sets"
    speedups = {key: path_leg["times"][key] / log_leg["times"][key]
                for key in ("list_ms", "prefix_ms", "scrub_ms", "gc_ms")}
    pt, lt = path_leg["times"], log_leg["times"]
    log(f"  config 18: {objects} refs in 32 x 16 directories; PUT path/log "
        f"{objects / pt['put_s']:.0f}/{objects / lt['put_s']:.0f} refs/s; "
        + "; ".join(f"{key[:-3]} {pt[key]:.2f} vs {lt[key]:.2f} ms "
                    f"({speedups[key]:.1f}x)" for key in speedups)
        + f"; snapshot {lt['snapshot_ms']:.1f} ms, cold index "
        f"{lt['cold_ms']:.1f} ms; {compared} refs byte-identical, listings, "
        f"prefix scans and liveness sets equal")
    return {"path": path_leg, "log": log_leg, "speedups": speedups,
            "compared": compared}


def ab_config17(path, be, rec, devices, geo: Geometry = AB17_GEO,
                parts: int = AB17_PARTS, batches: int = AB17_BATCHES,
                iters: int = AB17_ITERS, oracle=None) -> dict:
    """BASELINE config 17: ``be`` (one device) against ``MeshBackend`` over
    ``devices`` at the default depth and at depth 0, each through
    ``encode_hash_batches`` and ``reconstruct_batch_picked``, best of
    ``iters``.  Parity, digests and rebuilt rows equal the ``oracle``
    backend's (the port's numpy backend when None) and hashlib's on every
    leg; the pipelined leg's window shows overlap and the depth-0 leg's
    none."""
    from chunky_bits_tpu_torch.ops import matrix
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder, NumpyBackend
    from chunky_bits_tpu_torch.ops.mesh_backend import (MeshBackend,
                                                        plan_layout)

    d, p, size = geo.d, geo.p, geo.chunk
    rng = np.random.default_rng(SEED + 17)
    data = [rng.integers(0, 256, (parts, d, size), dtype=np.uint8)
            for _ in range(batches)]
    nbytes = batches * parts * d * size
    enc = matrix.build_encode_matrix(d, p)
    oracle = oracle or NumpyBackend()
    with ThreadPoolExecutor() as pool:
        parity = list(pool.map(lambda b: oracle.apply_matrix(enc[d:], b),
                               data))
    digests = [np.concatenate([hashlib_rows(b), hashlib_rows(o)], axis=1)
               for b, o in zip(data, parity)]
    erased = sorted(rng.choice(d + p, size=p, replace=False).tolist())
    present = [i for i in range(d + p) if i not in erased]
    picked = [np.ascontiguousarray(
        np.concatenate([b, o], axis=1)[:, present[:d]])
        for b, o in zip(data, parity)]
    lost = [np.concatenate([b, o], axis=1)[:, erased]
            for b, o in zip(data, parity)]
    legs = {"single": (be, rec),
            "mesh": MeshBackend(devices=devices),
            "mesh_nopipe": MeshBackend(depth=0, devices=devices)}
    for name in ("mesh", "mesh_nopipe"):
        legs[name] = (legs[name], DispatchRecorder(legs[name]))
    lay = plan_layout(len(devices), parts, d, size)
    expected, out = {}, {}

    def run(backend) -> dict:
        coder = ErasureCoder(d, p, backend)

        def encode():
            return coder.encode_hash_batches(data)

        def decode():
            return [coder.reconstruct_batch_picked(pk, present, erased)
                    for pk in picked]

        for (par, dig), want_p, want_d in zip(encode(), parity, digests):
            assert np.array_equal(par, want_p), "config 17: parity"
            assert np.array_equal(dig, want_d), "config 17: digests"
        for got, want in zip(decode(), lost):
            assert np.array_equal(got, want), "config 17: rebuilt rows"
        best = {}
        for label, fn in (("encode", encode), ("decode", decode)):
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            best[label] = gib_s(nbytes, min(times))
        return best

    for name, (backend, recorder) in legs.items():
        recorder.expected()
        tag = f"ab17_{name}"
        out[name] = path(tag, run, backend)
        expected[tag] = recorder.expected()
        st = getattr(backend, "pipeline", None)
        out[name]["window"] = vars(st.stats()) if st is not None else None
        log(f"  config 17 {name}: encode {out[name]['encode']:.3f} GiB/s, "
            f"decode {out[name]['decode']:.3f} GiB/s; launches "
            f"{expected[tag]}; window {out[name]['window']}")
    on, off = out["mesh"]["window"], out["mesh_nopipe"]["window"]
    assert (on["max_inflight"] >= 2 and on["submits_while_busy"] >= 1
            and on["host_overlap_s"] > 0 and on["cancelled"] == 0
            and on["completed"] == on["submitted"]), on
    assert (off["max_inflight"] <= 1 and off["submits_while_busy"] == 0
            and off["cancelled"] == 0), off
    out["layout"] = ("dp%d/%s%d" % (lay.dp, "tp" if lay.wide else "sp",
                                    lay.minor))
    log(f"  config 17: parity, digests and rebuilt rows equal to numpy and "
        f"hashlib on all three legs; mesh layout {out['layout']} (K2 "
        f"{'runs' if lay.wide else 'does not run'}); the pipelined window "
        f"overlapped ({on['max_inflight']} in flight, "
        f"{on['submits_while_busy']} submits while busy, "
        f"{on['host_overlap_s']:.4f} s of host work hidden), the depth-0 "
        f"one did not")
    return {"expected": expected, **out}


def phase_baseline_ab(blob: bytes, path, counts, be, devices) -> tuple:
    """The baseline_ab group: the JAX package's A/Bs of BASELINE configs
    4, 6, 7, 8, 10, 18 and 17 (bench.py) through the port's entry points
    on ``be``, each step a path of its own for the launch counts.
    Returns the expected launches and the commonest config-4 dispatch
    shape ``(B, r, k, S)`` for the timings."""
    import shutil
    import tempfile
    from collections import Counter

    expected = {}
    rec = ApplyRecorder(be)
    t_group = time.perf_counter()
    try:
        r4 = ab_config4(blob, path, be)
        expected.update(r4["expected"])
        shape = Counter(r4["legs"]["ab4_host_sha"]["shapes"]).most_common(
            1)[0][0]
        del r4
        stamp("baseline_ab config 4")
        with tempfile.TemporaryDirectory(prefix="cb_ab_") as root:
            for fn in (ab_config6, ab_config7, ab_config8, ab_config10):
                sub = os.path.join(root, fn.__name__)
                os.makedirs(sub)
                expected.update(fn(sub, blob, path, be, rec)["expected"])
                shutil.rmtree(sub)
                stamp(f"baseline_ab {fn.__name__}")
            sub = os.path.join(root, "ab18")
            os.makedirs(sub)
            path("ab18", ab_config18, sub)
            expected["ab18"] = {name: 0 for name in KERNELS}
            stamp("baseline_ab config 18")
        expected.update(ab_config17(path, be, rec, devices)["expected"])
        stamp("baseline_ab config 17")
    finally:
        rec.close()
    for name in expected:
        for kernel in KERNELS:
            expected[name].setdefault(kernel, 0)
    log(f"baseline_ab: {len(expected)} paths in "
        f"{time.perf_counter() - t_group:.1f} s; config 4's commonest "
        f"dispatch {list(shape)}")
    return expected, shape


# ------------------------------------------------------------ conformance
#
# The seeded geometries of the conformance fuzz (tests/test_conformance_fuzz.py
# and its mirror tests/test_torch_conformance_fuzz.py), drawn from the same
# seeds in the same order as the tests draw them.


def conf_lengths(stripe: int) -> list[int]:
    """The storage leg's object lengths for a stripe of ``stripe`` bytes:
    empty, one byte, a stripe less one, a stripe (an empty tail), a
    stripe and one, and three stripes and a tail."""
    return [0, 1, stripe - 1, stripe, stripe + 1, 3 * stripe + 17]


def conf_rs_cells() -> list[dict]:
    """The Reed-Solomon cells of the fuzz: ``random<n>``
    (test_random_geometry_roundtrip), ``xor<n>`` (test_xor_schedule_
    conformance) and ``mesh<n>`` (test_mesh_backend_conformance), each with
    its data ``[B, d, S]``, p and erasure patterns."""
    cells = []
    for family, seeds, base in (("random", 8, 0), ("xor", 6, 500),
                                ("mesh", 6, 1600)):
        for seed in range(seeds):
            rng = np.random.default_rng(base + seed)
            d = int(rng.integers(1, 17))
            p = int(rng.integers(0 if family == "random" else 1, 9))
            if family == "random":
                size = int(rng.integers(1, 3000))
                batch = int(rng.integers(1, 5))
            elif family == "xor":
                size = int(rng.integers(1, 300)) * 8
                batch = int(rng.integers(1, 4))
            else:
                size = int(rng.choice([1, 63, 65,
                                       int(rng.integers(1, 3000))]))
                batch = int(rng.integers(1, 6))
            data = rng.integers(0, 256, (batch, d, size), dtype=np.uint8)
            erasures = [rng.choice(d + p, size=int(rng.integers(1, p + 1)),
                                   replace=False)
                        for _ in range(4 if p else 0)]
            cells.append({"tag": f"{family}{seed}", "data": data, "p": p,
                          "erasures": erasures})
    return cells


def conf_aligned(cell: dict) -> dict:
    """``cell`` with its rows wrapped out to the next multiple of 256
    bytes: the stripe-aligned length inside the packed kernel's gate."""
    data = cell["data"]
    s = data.shape[2]
    pad = -(-s // 256) * 256 - s
    wide = np.pad(data, ((0, 0), (0, 0), (0, pad)), mode="wrap")
    return dict(cell, tag=cell["tag"] + "+a256", data=wide)


def conf_pm_geometry(rng) -> tuple[int, int]:
    """A random geometry pm-msr supports, as the fuzz draws it."""
    k = int(rng.integers(2, 7))
    return k, int(rng.integers(k - 1, k + 3))


def conf_pm_cells() -> list[dict]:
    """The pm-msr cells of the fuzz: ``pm<n>`` (test_pm_msr_conformance),
    ``pmxor<n>`` (test_pm_msr_xor_schedule_conformance), ``pmjax`` and
    ``pmmesh``, each with data, p, erasure patterns and (failed chunk,
    helpers) repairs."""
    cells = []
    for seed in range(8):
        rng = np.random.default_rng(900 + seed)
        k, p = conf_pm_geometry(rng)
        size = int(rng.integers(1, 400)) * (k - 1)
        batch = int(rng.integers(1, 4))
        data = rng.integers(0, 256, (batch, k, size), dtype=np.uint8)
        erasures = [rng.choice(k + p, size=int(rng.integers(1, p + 1)),
                               replace=False) for _ in range(4)]
        failures = []
        for _ in range(3):
            failed = int(rng.integers(0, k + p))
            others = [i for i in range(k + p) if i != failed]
            failures.append((failed, sorted(
                rng.permutation(others)[:2 * (k - 1)].tolist())))
        cells.append({"tag": f"pm{seed}", "data": data, "p": p,
                      "erasures": erasures, "failures": failures})
    for seed in range(4):
        rng = np.random.default_rng(950 + seed)
        k, p = conf_pm_geometry(rng)
        size = int(rng.integers(1, 60)) * 8 * (k - 1)
        data = rng.integers(0, 256, (2, k, size), dtype=np.uint8)
        erased = rng.choice(k + p, size=p, replace=False)
        failed = int(rng.integers(0, k + p))
        helpers = [i for i in range(k + p) if i != failed][:2 * (k - 1)]
        cells.append({"tag": f"pmxor{seed}", "data": data, "p": p,
                      "erasures": [erased], "failures": [(failed, helpers)]})
    for tag, k, p, seed, erased, failure in (
            ("pmjax", 3, 2, 1000, (0, 4), (0, [1, 2, 3, 4])),
            ("pmmesh", 5, 4, 1700, (1, 6), (1, [0, 2, 3, 4, 5, 6, 7, 8]))):
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, (2, k, 64 * (k - 1)), dtype=np.uint8)
        cells.append({"tag": tag, "data": data, "p": p,
                      "erasures": [erased], "failures": [failure]})
    return cells


def conf_raise_cells() -> list[dict]:
    """test_too_many_erasures_raise's cells: p+1 shards lost."""
    cells = []
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        d = int(rng.integers(2, 9))
        p = int(rng.integers(1, 5))
        data = rng.integers(0, 256, (1, d, 257), dtype=np.uint8)
        cells.append({"tag": f"raise{seed}", "data": data, "p": p,
                      "erased": rng.choice(d + p, size=p + 1,
                                           replace=False)})
    return cells


def conf_object_geometries() -> list[tuple]:
    """test_slab_vs_path_storage_roundtrip_fuzz's geometries ``(tag, d, p,
    chunk_log2, rng)``; the rng goes on to draw the payloads and
    erasures."""
    out = []
    for seed in range(4):
        rng = np.random.default_rng(300 + seed)
        d = int(rng.integers(2, 7))
        p = int(rng.integers(1, 4))
        out.append((f"slab{seed}", d, p, int(rng.integers(10, 14)), rng))
    return out


def plain_backend(torch, dev, packed: bool = False):
    """A backend whose every apply is the GF kernel's plain version on
    ``dev`` (the packed kernel's where ``packed`` and its gate admit the
    shape): what each kernel of a leg is held against."""
    from chunky_bits_tpu_torch.ops import gf_kernel
    from chunky_bits_tpu_torch.ops.backend import ErasureBackend

    class PlainOnDevice(ErasureBackend):
        name = "plain"

        def apply_matrix(self, mat, shards):
            table = gf_kernel.to_device_matrix(mat, dev)
            x = torch.from_numpy(np.ascontiguousarray(shards)).to(dev)
            r, k, s = mat.shape[0], x.shape[1], x.shape[2]
            fn = (gf_kernel.apply_matrix_packed_plain
                  if packed and gf_kernel.packed_geometry_ok(r, k, s)
                  else gf_kernel.apply_matrix_plain)
            return fn(table, x).cpu().numpy()

    return PlainOnDevice()


def conf_rs(backend, cells: list[dict]) -> list[tuple]:
    """Each cell through ``ErasureCoder(d, p, backend)``: its parity, and
    the rows rebuilt from the reference stripe for each erasure pattern."""
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder

    outs = []
    for cell in cells:
        data, p = cell["data"], cell["p"]
        d = data.shape[1]
        coder = ErasureCoder(d, p, backend)
        parity = coder.encode_batch(data)
        rebuilt = []
        for erased in cell["erasures"]:
            shards = [None if i in erased else cell["full"][0, i]
                      for i in range(d + p)]
            rebuilt.append(coder.reconstruct(shards))
        outs.append((parity, rebuilt))
    return outs


def check_conf_rs(leg: str, cells: list[dict], outs: list[tuple],
                  plain) -> None:
    """A leg's parity against numpy and the kernel's plain version, and
    every rebuilt row against the reference stripe."""
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder

    for cell, (parity, rebuilt) in zip(cells, outs):
        data, p = cell["data"], cell["p"]
        d = data.shape[1]
        assert np.array_equal(parity, cell["parity"]), (leg, cell["tag"])
        assert np.array_equal(
            parity, ErasureCoder(d, p, plain).encode_batch(data)), (
                leg, cell["tag"])
        for erased, rows in zip(cell["erasures"], rebuilt):
            for i in range(d + p):
                assert np.array_equal(rows[i], cell["full"][0, i]), (
                    leg, cell["tag"], list(erased), i)


def conf_encode_hash(backend, cells: list[dict]) -> list[tuple]:
    """Each cell through ``ErasureCoder.encode_hash_batch`` on
    ``backend``: ``(parity, digests)``."""
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder

    return [ErasureCoder(c["data"].shape[1], c["p"], backend)
            .encode_hash_batch(c["data"]) for c in cells]


def conf_pm(backend, cells: list[dict]) -> list[tuple]:
    """Each pm-msr cell through ``PMMSRCoder(k, p, backend)``: parity,
    rebuilt rows, helper projections and regenerated chunks."""
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    outs = []
    for cell in cells:
        data, p = cell["data"], cell["p"]
        k = data.shape[1]
        full = cell["full"]
        coder = PMMSRCoder(k, p, backend)
        parity = coder.encode_batch(data)
        rebuilt = [coder.reconstruct([None if i in erased else full[0, i]
                                      for i in range(k + p)])
                   for erased in cell["erasures"]]
        repairs = []
        for failed, helpers in cell["failures"]:
            projs = np.stack([coder.project_batch(failed, full[:, h, :])
                              for h in helpers], axis=1)
            repairs.append((projs, coder.repair_batch(failed, helpers,
                                                      projs)))
        outs.append((parity, rebuilt, repairs))
    return outs


def conf_objects(root: str, backend: str) -> list[str]:
    """The storage fuzz through clusters on ``backend``: every length of
    ``conf_lengths`` at each geometry, written through a ``slab:`` cluster
    and a path cluster and read back; the two give the same content
    addresses, and the slab object still reads after up to p extents of
    every part are deleted.  Returns a line per geometry."""
    from chunky_bits_tpu_torch.utils import aio

    lines = []
    for tag, d, p, chunk_log2, rng in conf_object_geometries():
        stripe = d * (1 << chunk_log2)
        geo = Geometry(d, p, 1 << chunk_log2, ())
        clusters = []
        for slabs in (d + p, 0):
            sub = os.path.join(root, f"{tag}_{'slab' if slabs else 'path'}")
            os.makedirs(sub)
            clusters.append(ab_cluster(sub, geo, backend, slabs=slabs))
        lengths = conf_lengths(stripe)

        async def run() -> None:
            for n, length in enumerate(lengths):
                payload = rng.integers(0, 256, length,
                                       dtype=np.uint8).tobytes()
                addresses = []
                for cluster in clusters:
                    await cluster.write_file(f"o{n}",
                                             aio.BytesReader(payload),
                                             cluster.get_profile())
                    ref = await cluster.get_file_ref(f"o{n}")
                    got = await cluster.file_read_builder(ref).read_all()
                    assert got == payload, (tag, length)
                    addresses.append([str(c.hash) for part in ref.parts
                                      for c in part.data + part.parity])
                assert addresses[0] == addresses[1], (tag, length)
                ref = await clusters[0].get_file_ref(f"o{n}")
                for part in ref.parts:
                    chunks = part.data + part.parity
                    for ci in rng.choice(len(chunks),
                                         size=int(rng.integers(1, p + 1)),
                                         replace=False):
                        await chunks[int(ci)].locations[0].delete()
                got = await clusters[0].file_read_builder(ref).read_all()
                assert got == payload, (tag, length, "after erasures")

        asyncio.run(run())
        lines.append(f"{tag} d={d} p={p} chunk 2^{chunk_log2}: lengths "
                     f"{lengths} equal through slab: and path, slab reads "
                     f"whole after erasures")
    return lines


def conf_raises(backend, rs_cells: list[dict], pm_cells: list[dict]
                ) -> int:
    """More than p erasures on ``backend``: every reconstruct raises
    ``ErasureError`` and returns no bytes.  Returns the cases raised."""
    from chunky_bits_tpu_torch.errors import ErasureError
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    raised = 0
    for cell in rs_cells + pm_cells:
        data, p = cell["data"], cell["p"]
        k = data.shape[1]
        coder = (PMMSRCoder if cell["tag"].startswith("pm")
                 else ErasureCoder)(k, p, backend)
        erased = cell.get("erased")
        if erased is None:
            erased = list(range(p + 1))
        full = cell["full"]
        present = [i for i in range(k + p) if i not in erased]
        attempts = [lambda: coder.reconstruct(
            [None if i in erased else full[0, i] for i in range(k + p)])]
        if coder.code == "rs":
            attempts.append(lambda: coder.reconstruct_batch(
                full, present, [int(i) for i in erased]))
        for attempt in attempts:
            try:
                got = attempt()
            except ErasureError:
                raised += 1
            else:
                raise AssertionError(f"{cell['tag']}: {p + 1} erasures "
                                     f"returned {type(got).__name__}")
    return raised


def config_info_child() -> dict:
    """``python -X importtime -m chunky_bits_tpu_torch config-info`` in a
    child: its wall seconds and whether it imported torch; and ``python
    -c 'import torch'`` beside it."""
    from chunky_bits_tpu_torch.cluster.tunables import (BACKEND_ENV,
                                                        environ_without)

    here = os.path.dirname(os.path.abspath(__file__))
    env = environ_without(BACKEND_ENV)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "chunky_bits_tpu_torch",
         "--config", os.devnull, "config-info", "--json"], cwd=here,
        env=env, check=True, timeout=300, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    assert json.loads(proc.stdout)["default_destination"]["type"] == "void"
    names = [line.rsplit("|", 1)[1].strip()
             for line in proc.stderr.splitlines()
             if line.startswith("import time:") and "|" in line]
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch"], cwd=here,
                   env=env, check=True, timeout=300)
    return {"config_info_s": wall,
            "torch_loaded": any(n == "torch" or n.startswith("torch.")
                                for n in names),
            "modules": len(names),
            "import_torch_s": time.perf_counter() - t0}


def phase_conformance(torch, dev, path, be, mesh_rec, tp_rec) -> dict:
    """The conformance group: the fuzz's seeded geometries through every
    kernel of the port.  Legs, each a path of its own for the launch
    counts: ``cuda`` (K1); ``cuda`` with the packed kernel on, each cell
    also at its length rounded up to 256 bytes (K3 inside its gate, K1
    outside); ``mesh`` on 8 logical devices (its layout per dispatch) and
    ``cuda:dp2,tp4`` for the cells whose d 4 divides (K2 and the
    reduce-and-pack); pm-msr on ``cuda``; the encode-and-hash route with
    device SHA on (K1 and the SHA kernel); the storage fuzz's objects at
    every adversarial length through ``slab:`` and path clusters; and
    more than p erasures, which must raise and launch nothing.  Every
    output is held against numpy (hashlib for digests) and the kernel's
    plain version on the card.  Then ``config-info`` in a child, timed,
    must load no torch.  Returns the expected launches."""
    import tempfile

    from chunky_bits_tpu_torch.ops import gf_kernel, matrix, sha256
    from chunky_bits_tpu_torch.ops.backend import ErasureCoder, NumpyBackend
    from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

    t_group = time.perf_counter()
    oracle = NumpyBackend()

    def with_reference(cell: dict) -> dict:
        data, p = cell["data"], cell["p"]
        coder = (PMMSRCoder if cell["tag"].startswith("pm")
                 else ErasureCoder)(data.shape[1], p, oracle)
        cell["parity"] = coder.encode_batch(data)
        cell["full"] = np.concatenate([data, cell["parity"]], axis=1)
        return cell

    rs = [with_reference(c) for c in conf_rs_cells()]
    coded = [c for c in rs if c["p"]]
    aligned = [with_reference(conf_aligned(c)) for c in coded]
    pm = [with_reference(c) for c in conf_pm_cells()]
    raise_cells = [with_reference(c) for c in conf_raise_cells()]
    plain = plain_backend(torch, dev)
    mesh_be, tp_be = mesh_rec.backend, tp_rec.backend
    mesh_rec.take()
    tp_rec.take()
    expected: dict[str, dict] = {}
    rec = ApplyRecorder(be)
    saved = be.packed, getattr(be, "device_sha", None)
    try:
        outs = path("conf_cuda", conf_rs, be, rs)
        expected["conf_cuda"] = rec.expected()
        check_conf_rs("cuda", rs, outs, plain)

        be.packed = True
        outs = path("conf_packed", conf_rs, be, coded + aligned)
        be.packed = saved[0]
        expected["conf_packed"] = expected_gf(be, rec.take(), True)
        check_conf_rs("packed", coded + aligned, outs,
                      plain_backend(torch, dev, packed=True))
        gated = sum(gf_kernel.packed_geometry_ok(c["p"], c["data"].shape[1],
                                                 c["data"].shape[2])
                    for c in aligned)

        outs = path("conf_mesh", conf_rs, mesh_be, coded)
        expected["conf_mesh"] = mesh_rec.expected()
        check_conf_rs("mesh", coded, outs, plain)
        tp_cells = [c for c in coded if c["data"].shape[1] % TP == 0]
        outs = path("conf_tp", conf_rs, tp_be, tp_cells)
        expected["conf_tp"] = tp_rec.expected()
        check_conf_rs(tp_be.name, tp_cells, outs, plain)
        # K2 and the reduce-and-pack alone against their plain versions
        # at each tp cell's encode, outside the counted paths
        for cell in tp_cells:
            d, p = cell["data"].shape[1], cell["p"]
            rows = matrix.build_encode_matrix(d, p)[d:]
            x = torch.from_numpy(cell["data"]).to(dev)
            partials = []
            for cols in np.array_split(np.arange(d), TP):
                sub = gf_kernel.to_device_matrix(rows[:, cols], dev)
                xs = x[:, cols].contiguous()
                acc = gf_kernel.accumulate(sub, xs)
                assert torch.equal(acc, gf_kernel.accumulate_plain(sub, xs))
                partials.append(acc)
            packed_out = gf_kernel.reduce_pack(partials)
            assert torch.equal(packed_out,
                               gf_kernel.reduce_pack_plain(partials))
            assert np.array_equal(packed_out.cpu().numpy(),
                                  cell["parity"]), cell["tag"]

        outs = path("conf_pm_msr", conf_pm, be, pm)
        expected["conf_pm_msr"] = rec.expected()
        mine = conf_pm(plain, pm)
        for cell, got, want in zip(pm, outs, mine):
            k, p = cell["data"].shape[1], cell["p"]
            oracle_pm = PMMSRCoder(k, p, oracle)
            assert np.array_equal(got[0], cell["parity"]), cell["tag"]
            assert np.array_equal(got[0], want[0]), cell["tag"]
            for rows in got[1]:
                for i in range(k + p):
                    assert np.array_equal(rows[i], cell["full"][0, i]), (
                        cell["tag"], i)
            for (failed, helpers), (projs, regen), (pprojs, _) in zip(
                    cell["failures"], got[2], want[2]):
                theirs = np.stack([oracle_pm.project_batch(
                    failed, cell["full"][:, h, :]) for h in helpers], axis=1)
                assert np.array_equal(projs, theirs), cell["tag"]
                assert np.array_equal(projs, pprojs), cell["tag"]
                assert np.array_equal(regen, cell["full"][:, failed, :]), (
                    cell["tag"], failed)

        be.device_sha = True
        fused = path("conf_device_sha", conf_encode_hash, be, rs)
        be.device_sha = saved[1]
        assert sum(rec.expected().values()) == 0
        expected["conf_device_sha"] = expected_fused(be, [
            (c["data"].shape[0], c["p"], c["data"].shape[1],
             c["data"].shape[2]) for c in coded])
        for cell, (parity, digests) in zip(rs, fused):
            assert np.array_equal(parity, cell["parity"]), cell["tag"]
            want = hashlib_rows(cell["full"])
            assert np.array_equal(digests, want), cell["tag"]
            rows = torch.from_numpy(cell["full"]).to(dev)
            plain_sha = sha256.sha256_rows_plain(
                rows.reshape(-1, rows.shape[2])).cpu().numpy()
            assert np.array_equal(plain_sha.reshape(want.shape), want)

        with tempfile.TemporaryDirectory(prefix="cb_conf_") as root:
            obj_lines = path("conf_objects", conf_objects, root, be.name)
        expected["conf_objects"] = rec.expected()

        raised = path("conf_raise", conf_raises, be, raise_cells, pm[:4])
        expected["conf_raise"] = rec.expected()
        assert raised == 2 * len(raise_cells) + 4, raised
    finally:
        be.packed = saved[0]
        be.device_sha = saved[1]
        rec.close()
    for name in expected:
        for kernel in KERNELS:
            expected[name].setdefault(kernel, 0)
    assert sum(expected["conf_raise"].values()) == 0
    for line in obj_lines:
        log(f"  {line}")
    patterns = sum(len(c["erasures"]) for c in rs)
    log(f"conformance: {len(rs)} rs cells ({patterns} erasure patterns) on "
        f"cuda, {len(coded + aligned)} with the packed kernel on ({gated} "
        f"inside its gate), {len(coded)} on mesh, {len(tp_cells)} on "
        f"{tp_be.name}, {len(pm)} pm-msr cells, {len(rs)} encode+hash with "
        f"device SHA, {6 * len(obj_lines)} objects x 2 "
        f"clusters; each equal to numpy or hashlib and the kernel's plain "
        f"version; {raised} reconstructs past p erasures raised "
        f"ErasureError")
    child = config_info_child()
    log(f"host import: python -m chunky_bits_tpu_torch config-info "
        f"{child['config_info_s']:.3f} s ({child['modules']} modules, torch "
        f"loaded: {child['torch_loaded']}); python -c 'import torch' "
        f"{child['import_torch_s']:.3f} s")
    assert not child["torch_loaded"], "config-info imported torch"
    log(f"conformance group: {len(expected)} paths in "
        f"{time.perf_counter() - t_group:.1f} s")
    return expected


def phase_timings(torch, dev, coder, data: np.ndarray,
                  parity: np.ndarray, repair_shapes=None,
                  ab_shape=None) -> list[dict]:
    """Each kernel at the main path's launch shape beside its plain
    version and its bound; the two GF kernels in turns (K1, K3, K3, K1).
    K1 also at the three commonest shapes of the repair planner's
    dispatches (``repair_shapes``, a Counter of ``(B, r, k, S)``), and K1
    and the SHA kernel at config 4's commonest dispatch (``ab_shape``)
    and K1 at config 8's one-part read.  No
    single PyTorch call computes any of the three functions, so
    ``library_ms`` is null."""
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
    k3 = gf_kernel.apply_matrix_packed(t_enc, x)
    k3_err = int((k3.int() - got.int()).abs().max())
    k3_plain = gf_kernel.apply_matrix_packed_plain(t_enc, x)
    k3_err = max(k3_err, int((k3.int() - k3_plain.int()).abs().max()))
    k3_dec = gf_kernel.apply_matrix_packed(t_dec, y)
    k3_dec_plain = gf_kernel.apply_matrix_packed_plain(t_dec, y)
    k3_err = max(k3_err, int((k3_dec.int() - dec_got.int()).abs().max()),
                 int((k3_dec.int() - k3_dec_plain.int()).abs().max()))
    del k3, k3_plain, k3_dec, k3_dec_plain
    kernel_ms = {"k1": [], "k3": [], "k1_dec": [], "k3_dec": []}
    for order in (("k1", "k3"), ("k3", "k1")):
        for which in order:
            fn = (gf_kernel.apply_matrix if which == "k1"
                  else gf_kernel.apply_matrix_packed)
            kernel_ms[which].append(time_cuda(torch, lambda: fn(t_enc, x)))
            kernel_ms[which + "_dec"].append(
                time_cuda(torch, lambda: fn(t_dec, y)))
    ms, ms_dec = (statistics.median(kernel_ms["k1"]),
                  statistics.median(kernel_ms["k1_dec"]))
    k3_ms, k3_ms_dec = (statistics.median(kernel_ms["k3"]),
                        statistics.median(kernel_ms["k3_dec"]))
    # the plain versions (seconds each) once, after the checks above ran
    # each of them already
    plain_ms = time_cuda(torch, lambda: gf_kernel.apply_matrix_plain(t_enc, x),
                         reps=1, warm=0)
    plain_ms_dec = time_cuda(
        torch, lambda: gf_kernel.apply_matrix_plain(t_dec, y), reps=1, warm=0)
    k3_plain_ms = time_cuda(
        torch, lambda: gf_kernel.apply_matrix_packed_plain(t_enc, x), reps=1,
        warm=0)
    k3_plain_ms_dec = time_cuda(
        torch, lambda: gf_kernel.apply_matrix_packed_plain(t_dec, y), reps=1,
        warm=0)
    nbytes = b * D * s + b * P * s + t_enc.numel()
    k1_bound, k1_by = gf_apply_bound(b, D, P, s, t_enc.numel())
    # K3's own work: the bit-plane product as int8 MACs
    ops = 2 * (8 * P) * (8 * D) * b * s
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    gf = {"name": "gf_apply", "route": "cuda",
          "source": "chunky_bits_tpu_torch/csrc/gf_apply.cu",
          "replaces": "chunky_bits_tpu/ops/pallas_kernels.py:222",
          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": k1_bound, "bound_by": k1_by,
          "library_ms": None, "shape": [b, D, s], "decode_ms": ms_dec,
          "decode_plain_ms": plain_ms_dec}
    log(f"gf_apply [{b}, {D}, {s}] -> [{b}, {P}, {s}]: encode {ms:.3f} ms, "
        f"4-erasure decode {ms_dec:.3f} ms; plain {plain_ms:.1f} / "
        f"{plain_ms_dec:.1f} ms; bound {gf['bound_ms']:.3f} ms "
        f"({gf['bound_by']}: {nbytes / 1e9:.2f} GB); max_abs_err {err} "
        f"against the plain version (tolerance 0: integer arithmetic); no "
        f"single PyTorch call computes it")
    # K1 at the other shapes the paths launch it at: one part of configs 2
    # and 5 (read and resilver dispatches, 10 launches back to back per
    # timing) and config 5's stripe of 8 parts (the cuda backend's blocks)
    for label, n, g in (("one_part", 1, CONFIG2), ("one_part_config5", 1,
                                                   CONFIG5),
                        ("config5", ACC_PARTS, CONFIG5)):
        enc = matrix.build_encode_matrix(g.d, g.p)
        t_g = gf_kernel.to_device_matrix(enc[g.d:], dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        x_g = torch.randint(0, 256, (n, g.d, g.chunk), generator=gen,
                            dtype=torch.uint8, device=dev)
        got_g = gf_kernel.apply_matrix(t_g, x_g)
        assert torch.equal(got_g, gf_kernel.apply_matrix_plain(t_g, x_g))
        ms_g = time_cuda(torch, lambda: gf_kernel.apply_matrix(t_g, x_g),
                         inner=10 if n == 1 else 1)
        bound_g, by_g = gf_apply_bound(n, g.d, g.p, g.chunk, t_g.numel())
        gf.update({f"{label}_shape": [n, g.d, g.chunk], f"{label}_ms": ms_g,
                   f"{label}_bound_ms": bound_g, f"{label}_bound_by": by_g})
        log(f"gf_apply [{n}, {g.d}, {g.chunk}] -> [{n}, {g.p}, {g.chunk}]: "
            f"{ms_g:.4f} ms, bound {bound_g:.4f} ms ({by_g}); equal to the "
            f"plain version")
        del x_g, got_g
    # K1 at the d=3 p=2 read shapes: two data rows rebuilt from chunks 2,
    # 3 and 4, for config 19's one-part and 8-part reads at 64 KiB and the
    # simulator's 8-part reads at 4 KiB (10 launches back to back)
    gf["small_decodes"] = []
    dec3 = matrix.decode_matrix(matrix.build_encode_matrix(3, 2), [2, 3, 4],
                                [0, 1])
    t_g = gf_kernel.to_device_matrix(dec3, dev)
    for label, n, s_ in (("config19 one part", 1, 64 << 10),
                         ("config19", 8, 64 << 10),
                         ("simulator", 8, SIM_CHUNK)):
        gen = torch.Generator(device=dev).manual_seed(SEED + 14)
        x_g = torch.randint(0, 256, (n, 3, s_), generator=gen,
                            dtype=torch.uint8, device=dev)
        got_g = gf_kernel.apply_matrix(t_g, x_g)
        assert torch.equal(got_g, gf_kernel.apply_matrix_plain(t_g, x_g))
        ms_g = time_cuda(torch, lambda: gf_kernel.apply_matrix(t_g, x_g),
                         inner=10)
        plain_g = time_cuda(
            torch, lambda: gf_kernel.apply_matrix_plain(t_g, x_g), reps=1)
        bound_g, by_g = gf_apply_bound(n, 3, 2, s_, t_g.numel())
        gf["small_decodes"].append({
            "label": label, "shape": [n, 3, s_], "rows": 2, "ms": ms_g,
            "plain_ms": plain_g, "bound_ms": bound_g, "bound_by": by_g})
        log(f"gf_apply at {label}'s decode shape [{n}, 3, {s_}] -> [{n}, 2, "
            f"{s_}]: {ms_g:.4f} ms, plain {plain_g:.3f} ms, bound "
            f"{bound_g:.5f} ms ({by_g}); equal to the plain version")
        del x_g, got_g
    # K1 at the baseline_ab group's shapes: config 4's commonest coalesced
    # encode and config 8's one-part read (two data rows rebuilt from
    # chunks 2, 3 and 4), 10 launches back to back
    gf["baseline_ab"] = []
    ab_cases = [("config8 one part", 1, 3, 2, AB8_GEO.chunk, dec3)]
    if ab_shape is not None:
        b4, r4, k4, s4 = ab_shape
        ab_cases.insert(0, ("config4", b4, k4, r4, s4,
                            matrix.build_encode_matrix(k4, r4)[k4:]))
    for label, n, k, r, s_, mat in ab_cases:
        t_g = gf_kernel.to_device_matrix(mat, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        x_g = torch.randint(0, 256, (n, k, s_), generator=gen,
                            dtype=torch.uint8, device=dev)
        got_g = gf_kernel.apply_matrix(t_g, x_g)
        err_g = int((got_g.int() - gf_kernel.apply_matrix_plain(t_g, x_g)
                     .int()).abs().max())
        assert err_g == 0, (label, err_g)
        ms_g = time_cuda(torch, lambda: gf_kernel.apply_matrix(t_g, x_g),
                         inner=10)
        plain_g = time_cuda(
            torch, lambda: gf_kernel.apply_matrix_plain(t_g, x_g), reps=1)
        bound_g, by_g = gf_apply_bound(n, k, r, s_, t_g.numel())
        gf["baseline_ab"].append({
            "label": label, "shape": [n, k, s_], "rows": r, "ms": ms_g,
            "plain_ms": plain_g, "bound_ms": bound_g, "bound_by": by_g,
            "max_abs_err": err_g})
        log(f"gf_apply at {label}'s shape [{n}, {k}, {s_}] -> [{n}, {r}, "
            f"{s_}]: {ms_g:.4f} ms, plain {plain_g:.3f} ms, bound "
            f"{bound_g:.5f} ms ({by_g}); equal to the plain version")
        if label == "config4":
            sha_case = (x_g, got_g)
        else:
            del x_g, got_g
    # K1 at the repair planner's commonest dispatch shapes (one part, a
    # digest block or a whole chunk; a pm-msr projection or combine)
    gf["repair"] = []
    for (n, r, k, s_), times in (repair_shapes or {}).most_common(3):
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        t_g = gf_kernel.to_device_matrix(
            matrix.build_encode_matrix(k, r)[k:], dev)
        x_g = torch.randint(0, 256, (n, k, s_), generator=gen,
                            dtype=torch.uint8, device=dev)
        got_g = gf_kernel.apply_matrix(t_g, x_g)
        assert torch.equal(got_g, gf_kernel.apply_matrix_plain(t_g, x_g))
        ms_g = time_cuda(torch, lambda: gf_kernel.apply_matrix(t_g, x_g),
                         inner=10)
        plain_g = time_cuda(
            torch, lambda: gf_kernel.apply_matrix_plain(t_g, x_g), reps=1)
        bound_g, by_g = gf_apply_bound(n, k, r, s_, t_g.numel())
        gf["repair"].append({"shape": [n, k, s_], "rows": r,
                             "launches": times, "ms": ms_g,
                             "plain_ms": plain_g, "bound_ms": bound_g,
                             "bound_by": by_g})
        log(f"gf_apply at a repair shape [{n}, {k}, {s_}] -> [{n}, {r}, "
            f"{s_}] ({times} launches): {ms_g:.4f} ms, plain "
            f"{plain_g:.3f} ms, bound {bound_g:.5f} ms ({by_g}); equal to "
            f"the plain version")
        del x_g, got_g
    packed = dict(gf, name="gf_apply_packed",
                  source="chunky_bits_tpu_torch/csrc/gf_apply_packed.cu",
                  replaces="chunky_bits_tpu/ops/pallas_kernels.py:157",
                  max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms,
                  decode_ms=k3_ms_dec, decode_plain_ms=k3_plain_ms_dec,
                  gf_apply_ms=ms, gf_apply_decode_ms=ms_dec)
    for key in [key for key in packed if key.startswith(("one_part",
                                                          "config5",
                                                          "repair",
                                                          "small_decodes",
                                                          "baseline_ab"))]:
        del packed[key]
    log(f"gf_apply_packed [{b}, {D}, {s}] -> [{b}, {P}, {s}]: encode "
        f"{k3_ms:.3f} ms, 4-erasure decode {k3_ms_dec:.3f} ms (gf_apply "
        f"{ms:.3f} / {ms_dec:.3f} ms in the same turns: "
        f"{kernel_ms}); plain {k3_plain_ms:.1f} / {k3_plain_ms_dec:.1f} ms; "
        f"bound {gf['bound_ms']:.3f} ms ({gf['bound_by']}; its int8 tensor "
        f"work {ops:.3g} ops is {t_ops:.3f} ms); max_abs_err {k3_err} "
        f"against its plain version and gf_apply (tolerance 0); no single "
        f"PyTorch call computes it")

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
    mix, per_pass = sass_loop_mix(_build.library_path("sha256_rows"))
    chain_ms, issued, int_pipe = sha_chain_floor(mix, per_pass, blocks)
    nbytes = rows_n * s + rows_n * 32
    ops = rows_n * blocks * sha256.OPS_PER_BLOCK
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    sha = {"name": "sha256_rows", "route": "cuda",
           "source": "chunky_bits_tpu_torch/csrc/sha256_rows.cu",
           "replaces": "chunky_bits_tpu/ops/sha256_jax.py:213",
           "max_abs_err": sha_err, "ms": ms_sha, "plain_ms": plain_sha,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "shape": [rows_n, s],
           "ops_per_block": sha256.OPS_PER_BLOCK,
           "chain_floor_ms": chain_ms,
           "consumer_instructions_per_block": issued,
           "consumer_int_pipe_per_block": int_pipe, "sass_loop": mix}
    with ThreadPoolExecutor() as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda r: hashlib.sha256(r).digest(), host_rows))
        host_ms = (time.perf_counter() - t0) * 1e3
    del host_rows
    if ab_shape is not None:
        # the SHA kernel at config 4's rows: the d+p rows of the commonest
        # coalesced dispatch, as its device-SHA leg launches it
        x4, par4 = sha_case
        n4 = x4.shape[0] * (x4.shape[1] + par4.shape[1])
        s4 = x4.shape[2]
        rows4 = torch.cat([x4, par4], dim=1).reshape(n4, s4)
        dig4 = sha256.sha256_parts(x4, par4).reshape(n4, 32)
        assert np.array_equal(dig4.cpu().numpy(),
                              hashlib_rows(rows4.cpu().numpy()))
        ms4 = time_cuda(torch, lambda: sha256.sha256_parts(x4, par4))
        held4 = []
        plain4 = time_cuda(
            torch, lambda: held4.append(sha256.sha256_rows_plain(rows4)),
            reps=1, warm=0)
        err4 = int((dig4.int() - held4[0].int()).abs().max())
        blocks4 = sha256.blocks_per_row(s4)
        t4_bytes = (n4 * s4 + n4 * 32) / HBM_BYTES_PER_S * 1e3
        t4_ops = (n4 * blocks4 * sha256.OPS_PER_BLOCK / INT32_OPS_PER_S
                  * 1e3)
        chain4, _, _ = sha_chain_floor(mix, per_pass, blocks4)
        sha["max_abs_err"] = max(sha["max_abs_err"], err4)
        sha["config4"] = {
            "shape": [n4, s4], "ms": ms4, "plain_ms": plain4,
            "bound_ms": max(t4_bytes, t4_ops),
            "bound_by": "bytes" if t4_bytes >= t4_ops else "operations",
            "chain_floor_ms": chain4, "max_abs_err": err4}
        log(f"sha256_rows at config 4's rows [{n4}, {s4}]: {ms4:.3f} ms, "
            f"plain {plain4:.1f} ms, bound {sha['config4']['bound_ms']:.3f} "
            f"ms ({sha['config4']['bound_by']}), chain floor {chain4:.3f} "
            f"ms; max_abs_err {err4}, all digests equal hashlib")
        del x4, par4, rows4, held4, sha_case
    log(f"sha256_rows consumer loop, one compression: {issued:.1f} "
        f"instructions, {int_pipe:.1f} of them on the integer pipe ({mix}, "
        f"{per_pass} compression(s) a pass); the whole function, counted "
        f"by hand: {sha256.OPS_PER_BLOCK}")
    log(f"sha256_rows [{rows_n}, {s}]: {ms_sha:.3f} ms; bound "
        f"{sha['bound_ms']:.3f} ms ({sha['bound_by']}: {ops:.3g} int32 ops"
        f" at {sha256.OPS_PER_BLOCK} a block on every lane, "
        f"{nbytes / 1e9:.2f} GB); chain floor {chain_ms:.3f} ms ({blocks} "
        f"compressions on one warp, each max({issued:.0f} instructions, 2 "
        f"x {int_pipe:.0f} integer-pipe ones) cycles at "
        f"{SM_CLOCK_HZ / 1e9:.2f} GHz); hashlib on all host cores "
        f"{host_ms:.1f} ms; plain version {plain_sha:.1f} ms on the same "
        f"rows, max_abs_err {sha_err} (tolerance 0: integer arithmetic); "
        f"all digests equal hashlib; no single PyTorch call computes it")
    return [gf, packed, sha]


def numpy_windows(mat: np.ndarray, data: np.ndarray,
                  out: np.ndarray) -> None:
    """``out`` against the numpy oracle on the first and last 64 KiB
    columns of ``data`` (GF transforms are column-wise, and numpy takes
    seconds per config-5 part)."""
    from chunky_bits_tpu_torch.ops.backend import NumpyBackend

    w = min(1 << 16, data.shape[2])
    for cols in (slice(0, w), slice(data.shape[2] - w, data.shape[2])):
        want = NumpyBackend().apply_matrix(
            mat, np.ascontiguousarray(data[:, :, cols]))
        assert np.array_equal(out[:, :, cols], want), cols


def phase_acc_kernel(torch, dev) -> None:
    """K2 against its plain version on the card, int16 element for
    element: odd shapes, an unaligned base, and config 5 at the whole
    stripe ``[8, 20, 4 MiB]`` and at each tp rank's ``[8, 5, 4 MiB]``.
    The packed sum of the four rank partials equals K1 and numpy, and so
    do the 6-erasure decode rows."""
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix

    g = CONFIG5
    kb = g.d // TP
    rng = np.random.default_rng(SEED + 6)
    enc = matrix.build_encode_matrix(g.d, g.p)
    cases = 0

    def check(mat: np.ndarray, x):
        nonlocal cases
        table = gf_kernel.to_device_matrix(mat, dev)
        got = gf_kernel.accumulate(table, x)
        assert got.dtype == torch.int16
        assert tuple(got.shape) == (x.shape[0], 8 * mat.shape[0], x.shape[2])
        assert torch.equal(got, gf_kernel.accumulate_plain(table, x)), (
            mat.shape, tuple(x.shape))
        cases += 1
        return got

    for b in (1, 3):
        for s in (1, 777, 4097):
            x = torch.from_numpy(rng.integers(0, 256, (b, g.d, s),
                                              dtype=np.uint8)).to(dev)
            check(enc[g.d:], x)
            check(enc[g.d:, :kb], x[:, :kb].contiguous())
    buf = torch.from_numpy(rng.integers(0, 256, 3 * g.d * 4096 + 1,
                                        dtype=np.uint8)).to(dev)
    check(enc[g.d:], buf[1:].view(3, g.d, 4096))
    cases += phase_acc_edges(torch, dev)

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randint(0, 256, (ACC_PARTS, g.d, g.chunk), generator=gen,
                      dtype=torch.uint8, device=dev)
    k1 = gf_kernel.apply_matrix(gf_kernel.to_device_matrix(enc[g.d:], dev), x)
    whole = check(enc[g.d:], x)
    assert torch.equal(gf_kernel.pack_acc(whole), k1)
    del whole
    parts = [check(enc[g.d:, t * kb:(t + 1) * kb],
                   x[:, t * kb:(t + 1) * kb].contiguous()) for t in range(TP)]
    parity = gf_kernel.reduce_pack(parts)
    assert torch.equal(parity, gf_kernel.reduce_pack_plain(parts)), (
        "reduce_pack != its plain version at config 5")
    del parts
    assert torch.equal(parity, k1), "packed rank partials != K1"
    numpy_windows(enc[g.d:], x.cpu().numpy(), parity.cpu().numpy())

    present = [i for i in range(g.d + g.p) if i not in g.lost][:g.d]
    dec = matrix.decode_matrix(enc, present, list(g.lost))
    rows = torch.cat([x, parity], dim=1)
    picked = rows[:, present].contiguous()
    acc = check(dec, picked)
    rebuilt = gf_kernel.pack_acc(acc)
    del acc
    assert torch.equal(rebuilt, gf_kernel.apply_matrix(
        gf_kernel.to_device_matrix(dec, dev), picked))
    assert torch.equal(rebuilt, rows[:, list(g.lost)])
    torch.cuda.synchronize()
    log(f"gf_acc: {cases} cases equal to its plain version (int16, "
        f"element for element), config 5 [{ACC_PARTS}, {g.d}, "
        f"{g.chunk}] and its {TP} tp ranks included; the rank partials "
        f"through gf_acc_pack equal its plain version, gf_apply and numpy, "
        f"and the packed {len(g.lost)}-erasure decode equals gf_apply and "
        f"the lost rows")


#: K2's edge cases: input rows around the k-steps of 4 (and a chunk of
#: 128 rows), output rows whose 8R is not a multiple of 16 (p = 1, 3) or
#: spans two blocks of 64 rows (p = 9), lengths around the 32-column unit
ACC_KS = (1, 4, 5, 20, 31, 32, 33)
ACC_PS = (1, 3, 6)
ACC_LENGTHS = (1, 7, 777, 4097)


def phase_acc_edges(torch, dev) -> int:
    """K2 against its plain version (int16 element for element) and a
    numpy count at its edges: every K of ``ACC_KS`` by every p of
    ``ACC_PS`` and S of ``ACC_LENGTHS`` at B = 3; p = 9; K = 130 (two
    chunks of the weight) and K = 4095 (32 chunks) on all-0xFF bytes, the
    counts in the thousands; an unaligned base.  Returns the cases."""
    from chunky_bits_tpu_torch.ops import gf_kernel

    rng = np.random.default_rng(SEED + 8)
    cases = 0

    def check(mat: np.ndarray, x, data: np.ndarray) -> None:
        nonlocal cases
        table = gf_kernel.to_device_matrix(mat, dev)
        got = gf_kernel.accumulate(table, x)
        assert torch.equal(got, gf_kernel.accumulate_plain(table, x)), (
            mat.shape, tuple(x.shape))
        m2 = gf_kernel.acc_weight(table).cpu().numpy().astype(np.int32)
        bits = np.unpackbits(data[..., None], axis=-1,
                             bitorder="little")  # [B, K, S, 8]
        bits = bits.transpose(0, 1, 3, 2).reshape(data.shape[0], -1,
                                                  data.shape[2])
        want = np.einsum("ok,bks->bos", m2, bits.astype(np.int32))
        assert np.array_equal(got.cpu().numpy(), want), (mat.shape,
                                                         data.shape)
        cases += 1

    def rand(shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    for k in ACC_KS:
        for p in ACC_PS:
            mat = rand((p, k))
            for s in ACC_LENGTHS:
                data = rand((3, k, s))
                check(mat, torch.from_numpy(data).to(dev), data)
    for p, k, s in ((9, 5, 777), (2, 130, 777)):
        data = rand((3, k, s))
        check(rand((p, k)), torch.from_numpy(data).to(dev), data)
    data = np.full((1, 4095, 40), 0xFF, dtype=np.uint8)
    check(np.full((1, 4095), 0xFF, dtype=np.uint8),
          torch.from_numpy(data).to(dev), data)
    flat = rand(3 * 20 * 4097 + 1)
    buf = torch.from_numpy(flat).to(dev)
    check(rand((6, 20)), buf[1:].view(3, 20, 4097),
          flat[1:].reshape(3, 20, 4097))
    torch.cuda.synchronize()
    log(f"gf_acc edges: {cases} cases (K {ACC_KS} x p {ACC_PS} x S "
        f"{ACC_LENGTHS}, p = 9, K = 130 and 4095, an unaligned base) equal "
        f"to its plain version and numpy")
    return cases


def phase_mesh(torch, dev, be, rec: DispatchRecorder, path,
               expected: dict) -> None:
    """The ``mesh`` backend on 8 logical devices of the card, through
    ``ErasureCoder.encode_hash_batches`` (the feed-ahead route) and the
    decode, at three layouts: config 5 at b=2 (dp2/tp4: K2), config 5 at
    b=16 (dp8: K1) and d=10 p=4 1 MiB at b=1 (dp1/sp8: K1 on 128 KiB
    slices).  Parity equals the ``cuda`` backend's and numpy's, every
    digest hashlib's, rebuilt rows the lost ones."""
    from chunky_bits_tpu_torch.ops import matrix
    from chunky_bits_tpu_torch.ops.backend import get_coder
    from chunky_bits_tpu_torch.ops.mesh_backend import plan_layout

    cells = ((CONFIG5, 2, 3, (True, 2, 4)), (CONFIG5, 16, 2, (False, 8, 1)),
             (CONFIG2, 1, 3, (False, 1, 8)))
    for n, (g, b, batches, layout) in enumerate(cells):
        lay = plan_layout(be.n_devices, b, g.d, g.chunk)
        assert (lay.wide, lay.dp, lay.minor) == layout, lay
        tag = f"mesh_d{g.d}_b{b}"
        coder = get_coder(g.d, g.p, be.name)
        gen = torch.Generator(device=dev).manual_seed(SEED + 10 + n)
        data = torch.randint(0, 256, (b * batches, g.d, g.chunk),
                             generator=gen, dtype=torch.uint8,
                             device=dev).cpu().numpy()
        before = be.pipeline.stats()
        t0 = time.perf_counter()
        outs = path(tag + "_encode", coder.encode_hash_batches,
                    [data[i * b:(i + 1) * b] for i in range(batches)])
        dt = time.perf_counter() - t0
        expected[tag + "_encode"] = rec.expected()
        after = be.pipeline.stats()
        parity = np.concatenate([o[0] for o in outs])
        digests = np.concatenate([o[1] for o in outs])
        assert np.array_equal(parity, get_coder(g.d, g.p, "cuda")
                              .encode_batch(data)), tag
        numpy_windows(coder.parity_rows, data, parity)
        want = np.concatenate([hashlib_rows(data), hashlib_rows(parity)],
                              axis=1)
        assert np.array_equal(digests, want), tag
        assert after.submits_while_busy > before.submits_while_busy, tag
        present = [i for i in range(g.d + g.p) if i not in g.lost]
        full = np.concatenate([data, parity], axis=1)
        picked = np.ascontiguousarray(full[:, present[:g.d]])
        t1 = time.perf_counter()
        rebuilt = path(tag + "_decode", coder.reconstruct_batch_picked,
                       picked, present, list(g.lost))
        dt_dec = time.perf_counter() - t1
        expected[tag + "_decode"] = rec.expected()
        assert np.array_equal(rebuilt, full[:, list(g.lost)]), tag
        log(f"mesh d={g.d} p={g.p} b={b} ({'dp%d/%s%d' % (lay.dp, 'tp' if lay.wide else 'sp', lay.minor)}): "
            f"{batches} batches through encode_hash_batches in "
            f"{dt * 1e3:.1f} ms ({gib_s(data.nbytes, dt):.2f} GiB/s), "
            f"{len(g.lost)}-erasure decode in {dt_dec * 1e3:.1f} ms; parity "
            f"equal to the cuda backend's and numpy's, all digests "
            f"hashlib's, rebuilt rows the lost ones")
    st = be.pipeline.stats()
    log(f"mesh dispatch window: {st}")
    assert st.max_inflight >= 2 and st.submits_while_busy >= 1, st
    assert st.cancelled == 0 and st.completed == st.submitted, st


def phase_acc_timings(torch, dev) -> dict:
    """K2 at the config-5 shapes beside its bound and its plain version;
    K1 on the same stripe in turns with K2 (K1, K2, K2, K1); the tp
    reduce-and-pack kernel beside its bound, its plain version and the
    torch ops it replaced.  No single PyTorch call computes either, so
    ``library_ms`` is null."""
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix

    g = CONFIG5
    kb = g.d // TP
    b, s = ACC_PARTS, g.chunk
    enc = matrix.build_encode_matrix(g.d, g.p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randint(0, 256, (b, g.d, s), generator=gen, dtype=torch.uint8,
                      device=dev)
    t_full = gf_kernel.to_device_matrix(enc[g.d:], dev)
    tables = [gf_kernel.to_device_matrix(enc[g.d:, t * kb:(t + 1) * kb], dev)
              for t in range(TP)]
    ranks = [x[:, t * kb:(t + 1) * kb].contiguous() for t in range(TP)]
    one = ranks[0][:1].contiguous()  # the main path's launch: one part

    got = gf_kernel.accumulate(tables[0], ranks[0])
    held = []
    plain_ms = time_cuda(
        torch, lambda: held.append(gf_kernel.accumulate_plain(tables[0],
                                                               ranks[0])),
        reps=1, warm=0)
    err = int((got.int() - held[0].int()).abs().max())
    del got, held
    ms = {"k1": [], "k2": []}
    for which in ("k1", "k2", "k2", "k1"):
        fn = gf_kernel.apply_matrix if which == "k1" else gf_kernel.accumulate
        ms[which].append(time_cuda(torch, lambda: fn(t_full, x)))
    k2_rank = time_cuda(torch, lambda: gf_kernel.accumulate(tables[0],
                                                            ranks[0]))
    k2_one = time_cuda(torch, lambda: gf_kernel.accumulate(tables[0], one),
                       inner=10)
    partials = [gf_kernel.accumulate(t, r) for t, r in zip(tables, ranks)]
    k1 = gf_kernel.apply_matrix(t_full, x)
    red = gf_kernel.reduce_pack(partials)
    assert torch.equal(red, k1), "reduce_pack != K1"
    red_err = int((red.int() - gf_kernel.reduce_pack_plain(
        partials).int()).abs().max())
    red_ms = time_cuda(torch, lambda: gf_kernel.reduce_pack(partials))
    red_plain_ms = time_cuda(
        torch, lambda: gf_kernel.reduce_pack_plain(partials), reps=3)

    def torch_ops():  # the tp path it replaced: in-place int16 sum, pack_acc
        total = partials[0]
        for q in partials[1:]:
            total.add_(q)
        return gf_kernel.pack_acc(total)

    torch_ops_ms = time_cuda(torch, torch_ops, reps=3)
    del partials, red

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    r8 = 8 * g.p

    def acc_bound(n: int, k: int) -> tuple[float, str]:
        # each input byte read once, an int16 per output bit written once;
        # the bit-plane product's int8 MACs at the tensor-core rate
        return bound(n * k * s + n * r8 * s * 2 + g.p * k * 8,
                     2 * r8 * 8 * k * n * s)

    rank_bound, rank_by = acc_bound(b, kb)
    full_bound, _ = acc_bound(b, g.d)
    one_bound, _ = acc_bound(1, kb)
    red_bytes = (TP * b * r8 * s * 2 + b * g.p * s) / HBM_BYTES_PER_S
    red_ops = TP * b * r8 * s / INT32_OPS_PER_S  # an XOR per partial count
    red_bound = max(red_bytes, red_ops) * 1e3
    k1_bound, _ = gf_apply_bound(b, g.d, g.p, s)
    k1_ms, k2_full = (statistics.median(ms["k1"]),
                      statistics.median(ms["k2"]))
    entry = {"name": "gf_acc", "route": "cuda",
             "source": "chunky_bits_tpu_torch/csrc/gf_acc.cu",
             "replaces": "chunky_bits_tpu/ops/pallas_kernels.py:222 "
                         "(pack=False)",
             "max_abs_err": err, "ms": k2_rank, "plain_ms": plain_ms,
             "bound_ms": rank_bound, "bound_by": rank_by,
             "library_ms": None, "shape": [b, kb, s],
             "full_stripe_shape": [b, g.d, s], "full_stripe_ms": k2_full,
             "full_stripe_bound_ms": full_bound,
             "gf_apply_full_stripe_ms": k1_ms,
             "gf_apply_full_stripe_bound_ms": k1_bound,
             "main_path_shape": [1, kb, s], "main_path_ms": k2_one,
             "main_path_bound_ms": one_bound, "turns_ms": ms}
    pack = {"name": "gf_acc_pack", "route": "cuda",
            "source": "chunky_bits_tpu_torch/csrc/gf_acc_pack.cu",
            "replaces": "not a TPU kernel: jax.lax.psum over tp "
                        "(chunky_bits_tpu/parallel/mesh.py:322) + "
                        "pack_acc_bitmajor "
                        "(chunky_bits_tpu/ops/pallas_kernels.py:350)",
            "max_abs_err": red_err, "ms": red_ms, "plain_ms": red_plain_ms,
            "bound_ms": red_bound,
            "bound_by": "bytes" if red_bytes >= red_ops else "operations",
            "library_ms": None, "shape": [TP, b, r8, s],
            "torch_ops_ms": torch_ops_ms}
    log(f"gf_acc [{b}, {kb}, {s}] -> int16 [{b}, {r8}, {s}] (one tp rank): "
        f"{k2_rank:.3f} ms, bound {rank_bound:.3f} ms ({rank_by}); plain "
        f"{plain_ms:.1f} ms, max_abs_err {err} (tolerance 0: integer "
        f"arithmetic); at the main path's [1, {kb}, {s}] {k2_one:.3f} ms, "
        f"bound {one_bound:.3f} ms; no single PyTorch call computes it")
    log(f"gf_acc [{b}, {g.d}, {s}] (whole stripe) {k2_full:.3f} ms, bound "
        f"{full_bound:.3f} ms; gf_apply on the same stripe {k1_ms:.3f} ms, "
        f"bound {k1_bound:.3f} ms (turns K1, K2, K2, K1: {ms})")
    log(f"gf_acc_pack of {TP} int16 partials [{b}, {r8}, {s}]: "
        f"{red_ms:.3f} ms, bound {red_bound:.3f} ms ({pack['bound_by']}); "
        f"plain version {red_plain_ms:.3f} ms, max_abs_err {red_err} "
        f"(tolerance 0: integer arithmetic); the torch ops it replaces "
        f"(in-place int16 sum, pack_acc) {torch_ops_ms:.3f} ms; no single "
        f"PyTorch call computes it")
    return [entry, pack]


def phase_all_gpus(torch, devices) -> None:
    """The mesh backends over ``devices`` (one logical device per card
    here): every layout ``plan_layout`` picks for a few batches, and every
    explicit spec the cards divide into, against the numpy oracle (64 KiB
    windows) and the ``cuda`` backend, launches counted per dispatch; the
    tp partials cross cards by ``.to()``.  Then config 5 at b=8 through
    ``cuda:tp<n>`` and ``mesh``, timed beside the ``cuda`` backend."""
    from chunky_bits_tpu_torch.ops import gf_kernel, matrix
    from chunky_bits_tpu_torch.ops.backend import get_coder
    from chunky_bits_tpu_torch.ops.mesh_backend import MeshBackend, plan_layout
    from chunky_bits_tpu_torch.parallel.backend import MeshCudaBackend

    n = len(devices)
    g = CONFIG5
    enc = matrix.build_encode_matrix(g.d, g.p)
    ref = get_coder(g.d, g.p, "cuda")
    rng = np.random.default_rng(SEED + 20)
    specs = [f"dp{n}", f"sp{n}"] + [f"dp{n // t},tp{t}"
                                    for t in range(2, n + 1)
                                    if n % t == 0 and g.d % t == 0]
    backends = [MeshBackend(devices=devices)] + [
        MeshCudaBackend(spec, devices=devices) for spec in specs]
    checked = []
    for be in backends:
        rec = DispatchRecorder(be)
        for b, s in ((1, 1 << 20), (2, (1 << 20) + 7), (n, 1 << 20),
                     (2 * n + 1, 4097)):
            data = rng.integers(0, 256, (b, g.d, s), dtype=np.uint8)
            gf_kernel.LAUNCHES = gf_kernel.ACC_LAUNCHES = 0
            gf_kernel.REDUCE_PACK_LAUNCHES = 0
            got = be.apply_matrix(enc[g.d:], data)
            launched = {"gf_apply": gf_kernel.LAUNCHES,
                        "gf_acc": gf_kernel.ACC_LAUNCHES,
                        "gf_acc_pack": gf_kernel.REDUCE_PACK_LAUNCHES}
            want = rec.expected()
            assert launched == {k: want[k] for k in launched}, (
                be.name, b, s, launched, want)
            assert np.array_equal(got, ref.encode_batch(data)), (be.name, b)
            numpy_windows(enc[g.d:], data, got)
            lay = (plan_layout(n, b, g.d, s) if be.name == "mesh"
                   else be._layout(b, g.d, s))
            checked.append(f"{be.name} b={b}: {'tp' if lay.wide else 'sp'}"
                           f"{lay.minor}/dp{lay.dp} {launched}")
    for line in checked:
        log(f"  {line}")
    log(f"all GPUs: {len(checked)} dispatches over {n} cards equal to the "
        f"cuda backend and numpy, each with the launches its blocks call "
        f"for")
    dev = devices[0].device
    # the reduce-and-pack on partials that crossed cards: card t's K2
    # partial of its column block, copied to the first card
    table = gf_kernel.to_device_matrix(enc[g.d:], dev)
    blocks = np.array_split(np.arange(g.d), n)
    for b, s in ((1, g.chunk + 7), (3, 4097)):
        data = torch.from_numpy(rng.integers(0, 256, (b, g.d, s),
                                             dtype=np.uint8))
        partials = []
        for ld, cols in zip(devices, blocks):
            sub = gf_kernel.to_device_matrix(enc[g.d:, cols], ld.device)
            x = data[:, cols].contiguous().to(ld.device)
            partials.append(gf_kernel.accumulate(sub, x).to(dev))
        torch.cuda.synchronize()
        before = gf_kernel.REDUCE_PACK_LAUNCHES
        got = gf_kernel.reduce_pack(partials)
        assert gf_kernel.REDUCE_PACK_LAUNCHES == before + 1
        assert torch.equal(got, gf_kernel.reduce_pack_plain(partials)), (b, s)
        assert torch.equal(got, gf_kernel.apply_matrix_plain(
            table, data.to(dev))), (b, s)
        log(f"  reduce_pack of {n} partials int16 [{b}, {8 * g.p}, {s}] "
            f"from {n} cards: equal to reduce_pack_plain and the transform")
    del partials, got
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    data = torch.randint(0, 256, (ACC_PARTS, g.d, g.chunk), generator=gen,
                         dtype=torch.uint8, device=dev).cpu().numpy()
    want = ref.encode_batch(data)
    for be in [ref.backend] + backends:
        be.apply_matrix(enc[g.d:], data)  # warm: pinned staging, tables
        t0 = time.perf_counter()
        got = be.apply_matrix(enc[g.d:], data)
        dt = time.perf_counter() - t0
        assert np.array_equal(got, want), be.name
        log(f"  config 5 [{ACC_PARTS}, {g.d}, {g.chunk}] through {be.name}: "
            f"{dt * 1e3:.1f} ms host to host, {gib_s(data.nbytes, dt):.2f} "
            f"GiB/s of data")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--sanitizer-worker"]:
        return sanitizer_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from chunky_bits_tpu_torch.ops.backend import (get_backend, get_coder,
                                                   register_backend)
    from chunky_bits_tpu_torch.ops.mesh_backend import MeshBackend
    from chunky_bits_tpu_torch.parallel.backend import MeshCudaBackend
    from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
    from chunky_bits_tpu_torch.utils.virtualmesh import virtual_devices

    dev = torch.device("cuda", 0)
    smi = phase_device(torch)
    phase_build()
    if "--all-gpus" in sys.argv[1:]:
        from chunky_bits_tpu_torch.utils.virtualmesh import visible_devices

        devices = visible_devices()  # one logical device per card
        assert len({ld.device for ld in devices}) >= 2, \
            "--all-gpus needs two or more cards"
        phase_all_gpus(torch, devices)
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    phase_kernels(torch, dev)
    phase_packed_kernel(torch, dev)
    phase_acc_kernel(torch, dev)
    phase_reduce_pack(torch, dev)
    stamp("build and kernel checks")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randint(0, 256, (INGEST_PARTS, D, CHUNK), generator=gen,
                         dtype=torch.uint8, device=dev).cpu().numpy()
    coder = get_coder(D, P)
    be = coder.backend
    assert be.name == "cuda", be.name

    # each path runs with every count set to 0 just before it and read
    # just after, and must launch what its blocks and dispatches call for
    counts: dict[str, dict[str, int]] = {}

    def path(name: str, fn, *args):
        zero_counts()
        out = fn(*args)
        counts[name] = read_counts()
        return out

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
    # the same paths with the packed kernel: it takes every launch K1
    # took (d=10 p=4 at 1 MiB is inside its gate), with the same bytes
    be.packed = True
    host_p = path("ingest_host_sha_packed", phase_ingest, coder, data, False)
    dev_p = path("ingest_device_sha_packed", phase_ingest, coder, data, True)
    for got in (host_p, dev_p):
        assert np.array_equal(got[0], parity), "packed parity differs"
        assert np.array_equal(got[1], digests), "packed digests differ"
    path("degraded_read_packed", phase_degraded, coder, data, parity)
    enc_p = path("batch_encode_packed", phase_batch_encode, data, parity,
                 digests)
    rec_p = path("batch_reconstruct_packed", phase_batch_reconstruct, data,
                 parity)
    be.packed = None
    for name, dispatches in (("batch_encode", enc_p.dispatches),
                             ("batch_reconstruct", rec_p.dispatches)):
        expected[name + "_packed"] = {"gf_apply": dispatches}
    for name in ("ingest_host_sha", "ingest_device_sha", "degraded_read"):
        expected[name + "_packed"] = dict(expected[name])
    for name in list(expected):
        want = expected[name]
        want.setdefault("sha256_rows", 0)
        want.setdefault("gf_acc", 0)
        want.setdefault("gf_acc_pack", 0)
        k1 = want.pop("gf_apply")
        packed_path = name.endswith("_packed")
        want["gf_apply"] = 0 if packed_path else k1
        want["gf_apply_packed"] = k1 if packed_path else 0
    log("erasure plane with the packed kernel: parity and digests on both "
        "ingest routes, rebuilt rows and batcher results equal to the "
        "packed-off run")
    stamp("erasure plane")

    # the object codec: BASELINE.md config 2 (10 GiB) through the writer,
    # packed off and on, then a ~1 GiB object round trip on disk
    blob = np.random.default_rng(SEED + 4).integers(
        0, 256, BLOB_BYTES, dtype=np.uint8).tobytes()
    refs = []
    for packed in (False, True):
        be.packed = packed
        pipeline = HostPipeline()
        phase_object_ingest_warm(blob, pipeline)
        name = "object_ingest" + ("_packed" if packed else "")
        ref, batcher = path(name, phase_object_ingest, blob, pipeline,
                            f"packed={packed}")
        log(f"  host pipeline: {pipeline.stats()}")
        pipeline.close()
        expected[name] = expected_gf(be, batcher.shapes, packed)
        refs.append(ref)
    be.packed = None
    assert refs[0].to_obj() == refs[1].to_obj(), "references differ"
    log("object ingest: file references equal packed off and on")
    check_object_ref(refs[0], blob)
    del refs
    stamp("config-2 object ingests")
    pipeline = HostPipeline()
    for packed in (False, True):
        be.packed = packed
        expected.update(phase_round_trip(
            blob, pipeline, path, "_packed" if packed else "",
            lambda b, packed=packed: expected_gf(be, b.shapes, packed)))
    be.packed = None
    pipeline.close()

    # the multi-device plane on 8 logical devices of the card (what
    # CHUNKY_BITS_TORCH_VIRTUAL_DEVICES=8 gives), registered under the
    # names a user selects: ``mesh`` and ``cuda:dp2,tp4``
    devices = virtual_devices(8, dev)
    mesh_be = MeshBackend(devices=devices)
    tp_be = MeshCudaBackend("dp2,tp4", devices=devices)
    assert tp_be.name == "cuda:dp2,tp4"
    for sharded in (mesh_be, tp_be):
        register_backend(sharded)
        assert get_backend(sharded.name) is sharded
    mesh_rec, tp_rec = DispatchRecorder(mesh_be), DispatchRecorder(tp_be)
    stamp("config-3 round trips")
    phase_mesh(torch, dev, mesh_be, mesh_rec, path, expected)
    stamp("mesh layouts")

    # BASELINE.md config 5 through cuda:dp2,tp4: a 10 GiB ingest whose
    # reference equals the cuda backend's, then a ~1 GiB round trip on
    # disk with 6 shards of every part lost
    pipeline = HostPipeline()
    refs = []
    for name in (tp_be.name, "cuda"):
        tag = "object5_ingest_" + ("tp" if name == tp_be.name else "cuda")
        ref, batcher = path(tag, phase_object_ingest, blob, pipeline, name,
                            CONFIG5, OBJECT5_PARTS, OBJECT5_BATCH,
                            OBJECT5_STAGE, name)
        expected[tag] = (tp_rec.expected() if name == tp_be.name
                         else expected_gf(be, batcher.shapes, False))
        log(f"  host pipeline: {pipeline.stats()}")
        refs.append(ref)
    assert refs[0].to_obj() == refs[1].to_obj(), "config-5 references differ"
    log("object ingest config 5: the file reference through cuda:dp2,tp4 "
        "equals the cuda backend's")
    check_object_ref(refs[0], blob, CONFIG5, OBJECT5_PARTS, sample=2)
    del refs
    expected.update(phase_round_trip(
        blob, pipeline, path, "_tp", lambda _b: tp_rec.expected(), CONFIG5,
        DISK5_PARTS, tp_be.name))
    pipeline.close()
    log(f"cuda:dp2,tp4 dispatch window: {tp_be.pipeline.stats()}")
    stamp("config-5 ingests and round trip")

    # the cluster_cli group: the port's CLI over cluster YAMLs
    expected.update(phase_cluster_cli(blob, path, counts, be, tp_be,
                                      tp_rec))
    stamp("cluster_cli")

    # the gateway group: the HTTP gateway and http:// destinations
    expected.update(phase_gateway(blob, path, counts, be, tp_rec))
    stamp("gateway")

    # the storage group: slab, meta-log, scrub and the repair planner
    storage_expected, repair_shapes = phase_storage(blob, path, counts, be,
                                                    tp_rec)
    expected.update(storage_expected)
    stamp("storage")

    # the host_codec group: the native host codec on the card's box
    expected.update(phase_host_codec(blob, path, counts, be))
    stamp("host_codec")

    # the serving_opt_in group: QoS, the SLO engine and multi-host
    expected.update(phase_serving_opt_in(path, counts, be, tp_rec))
    stamp("serving_opt_in")

    # the simulator group: scenarios, SLO detection and the crash harness
    sim_expected, sim_off = phase_simulator(path, counts, be, tp_rec)
    expected.update(sim_expected)
    stamp("simulator")

    # the sanitizer group: ingest, gateway and a scenario with the runtime
    # concurrency sanitizer off here and on in a child, then the linter
    expected.update(phase_sanitizer(blob, path, counts, be, tp_rec, sim_off,
                                    smi))
    stamp("sanitizer")

    # the baseline_ab group: the JAX package's A/Bs of BASELINE configs 4,
    # 6, 7, 8, 10, 18 and 17 through the port's entry points on the card
    ab_expected, ab_shape = phase_baseline_ab(blob, path, counts, be,
                                              devices)
    expected.update(ab_expected)
    stamp("baseline_ab")

    # the conformance group: the conformance fuzz's seeded geometries
    # through every kernel, and the CLI's host path without torch
    expected.update(phase_conformance(torch, dev, path, be, mesh_rec,
                                      tp_rec))
    stamp("conformance")

    for name, got in counts.items():
        log(f"launches on {name}: {got}")
    assert counts == expected, (counts, expected)

    kernels = phase_timings(torch, dev, coder, data, parity,
                            repair_shapes, ab_shape)
    del data, parity, digests
    kernels.extend(phase_acc_timings(torch, dev))
    stamp("timings")
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
