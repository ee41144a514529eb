#!/usr/bin/env python3
"""Time the port's hand-written kernels against an earlier design of each,
in turns, on one NVIDIA card.

    python3 scripts/torch_kernel_turns.py --old-dir DIR

DIR holds earlier sources of any of ``gf_apply.cu`` (K1),
``sha256_rows.cu`` and ``gf_acc.cu`` (K2), with the same C interface as
``chunky_bits_tpu_torch/csrc/`` (for example ``git show
<rev>:chunky_bits_tpu_torch/csrc/gf_apply.cu > DIR/gf_apply.cu``, DIR being
a directory that ``.gitignore`` lists); a kernel whose source is not there
is not timed.  The script builds them with the flags of ``ops/_build.py``
into DIR, holds the current kernels against their plain versions and
numpy/hashlib at their edge cases (``chip_smoke.phase_apply_edges``,
``phase_sha_edges``, ``phase_acc_edges`` and ``phase_reduce_pack``) and
against the earlier design at the timed shapes, then times both designs at
the main path's shapes in turns (old, new, new, old; each a CUDA-event
median of 5 after a warm-up, 10 launches back to back per timing at the
one-part shapes), both called through ctypes in the same way:

* K1 at ``[128, 10, 1 MiB] -> [128, 4, 1 MiB]`` (encode, and the
  4-erasure decode rows), config 5's ``[8, 20, 4 MiB] -> [8, 6, 4 MiB]``
  and one part of each, ``[1, 10, 1 MiB]`` and ``[1, 20, 4 MiB]``;
* SHA at the fused ingest block, 128 parts x (10 + 4) rows of 1 MiB;
* K2 at the main path's ``[1, 5, 4 MiB]``, a tp rank's ``[8, 5, 4 MiB]``
  and the whole config-5 stripe ``[8, 20, 4 MiB]`` (-> int16 [B, 48, S]).

It also times the reduce-and-pack kernel against the torch ops it
replaced on the tp path (an in-place int16 sum and ``pack_acc``) at config
5, 8 parts and tp = 4, in turns (torch ops, kernel, kernel, torch ops).
Prints the card's name and power limit, a line per shape, and one JSON
object last.  Imports nothing of JAX or of ``chunky_bits_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo's smoke script: shared helpers)

NAMES = ("gf_apply", "sha256_rows", "gf_acc")
K2_SHAPES = ((1, 5), (8, 5), (8, 20))  # (parts, input rows) of config 5


def build_old(old_dir: str) -> dict[str, ctypes.CDLL]:
    from chunky_bits_tpu_torch.ops import _build

    libs = {}
    for name in NAMES:
        if not os.path.exists(os.path.join(old_dir, f"{name}.cu")):
            continue
        lib = os.path.join(old_dir, f"lib{name}-old.so")
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(old_dir, f"{name}.cu")],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the old {name}.cu:\n"
                             f"{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  old {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, f"cb_{name}")
    fn.restype = ctypes.c_int
    if name == "sha256_rows":
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
    return fn


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old-dir", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_turns: CUDA is not available", file=sys.stderr)
        return 2
    from chunky_bits_tpu_torch.ops import _build, gf_kernel, matrix, sha256

    dev = torch.device("cuda", 0)
    smi = chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    old = {n: bind(lib, n) for n, lib in build_old(args.old_dir).items()}
    new = {n: bind(_build.load(n), n) for n in NAMES}
    chip_smoke.phase_apply_edges(torch, dev)
    chip_smoke.phase_sha_edges(torch, dev)
    chip_smoke.phase_acc_edges(torch, dev)
    chip_smoke.phase_reduce_pack(torch, dev)

    def stream() -> int:
        return torch.cuda.current_stream(dev).cuda_stream

    def sha(fn, a, b, out):
        assert fn(a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1],
                  a.shape[0], a.shape[2], out.data_ptr(), stream()) == 0

    def acc(fn, table, x, out):
        assert fn(table.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0],
                  x.shape[1], table.shape[0], x.shape[2], stream()) == 0

    def turns(run_old, run_new, inner: int = 1) -> dict:
        ms = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = run_old if which == "old" else run_new
            ms[which].append(chip_smoke.time_cuda(torch, fn, inner=inner))
        return {"old_ms": statistics.median(ms["old"]),
                "new_ms": statistics.median(ms["new"]), "turns_ms": ms}

    hbm, int8 = chip_smoke.HBM_BYTES_PER_S, chip_smoke.INT8_TENSOR_OPS_PER_S
    results = {}
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    if "sha256_rows" in old:
        s = chip_smoke.CHUNK
        a = torch.randint(0, 256, (chip_smoke.KERNEL_PARTS, chip_smoke.D, s),
                          generator=gen, dtype=torch.uint8, device=dev)
        b = torch.randint(0, 256, (chip_smoke.KERNEL_PARTS, chip_smoke.P, s),
                          generator=gen, dtype=torch.uint8, device=dev)
        outs = [torch.empty((a.shape[0], a.shape[1] + b.shape[1], 32),
                            dtype=torch.uint8, device=dev) for _ in range(2)]
        sha(old["sha256_rows"], a, b, outs[0])
        sha(new["sha256_rows"], a, b, outs[1])
        assert torch.equal(outs[0], outs[1]), "SHA: old and new designs differ"
        rows = outs[0].shape[0] * outs[0].shape[1]
        r = turns(lambda: sha(old["sha256_rows"], a, b, outs[0]),
                  lambda: sha(new["sha256_rows"], a, b, outs[1]))
        blocks = sha256.blocks_per_row(s)
        mix, per_pass = chip_smoke.sass_loop_mix(_build.library_path(
            "sha256_rows"))
        floor, issued, int_pipe = chip_smoke.sha_chain_floor(mix, per_pass,
                                                             blocks)
        r.update(shape=[rows, s],
                 bound_ms=max(rows * (s + 32) / hbm,
                              rows * blocks * sha256.OPS_PER_BLOCK
                              / chip_smoke.INT32_OPS_PER_S)
                 * 1e3,
                 chain_floor_ms=floor, consumer_instructions_per_block=issued,
                 consumer_int_pipe_per_block=int_pipe, sass_loop=mix)
        results["sha256_rows"] = r
        print(f"sha256_rows [{rows}, {s}]: old {r['old_ms']:.3f} ms, new "
              f"{r['new_ms']:.3f} ms (turns {r['turns_ms']}); bound "
              f"{r['bound_ms']:.3f} ms, chain floor "
              f"{r['chain_floor_ms']:.3f} ms ({issued:.1f} consumer "
              f"instructions a compression, {int_pipe:.1f} on the integer "
              f"pipe: {mix}, {per_pass} a pass)",
              flush=True)
        del a, b, outs

    g = chip_smoke.CONFIG5
    if "gf_apply" in old:
        # K1 at (parts, geometry, decode): the encode rows, or the decode
        # rows of the erasures chip_smoke.py reads with
        for n, geo, decode in ((chip_smoke.KERNEL_PARTS, chip_smoke.CONFIG2,
                                False),
                               (chip_smoke.KERNEL_PARTS, chip_smoke.CONFIG2,
                                True),
                               (chip_smoke.ACC_PARTS, g, False),
                               (1, chip_smoke.CONFIG2, False), (1, g, False)):
            enc = matrix.build_encode_matrix(geo.d, geo.p)
            mat = enc[geo.d:]
            if decode:
                present = [i for i in range(geo.d + geo.p)
                           if i not in geo.lost][:geo.d]
                mat = matrix.decode_matrix(enc, present, list(geo.lost))
            table = gf_kernel.to_device_matrix(mat, dev)
            s = geo.chunk
            x = torch.randint(0, 256, (n, geo.d, s), generator=gen,
                              dtype=torch.uint8, device=dev)
            outs = [torch.empty((n, mat.shape[0], s), dtype=torch.uint8,
                                device=dev) for _ in range(2)]
            acc(old["gf_apply"], table, x, outs[0])
            acc(new["gf_apply"], table, x, outs[1])
            assert torch.equal(outs[0], outs[1]), (
                f"K1 [{n}, {geo.d}]: designs differ")
            assert torch.equal(outs[1], gf_kernel.apply_matrix_plain(table,
                                                                      x))
            r = turns(lambda: acc(old["gf_apply"], table, x, outs[0]),
                      lambda: acc(new["gf_apply"], table, x, outs[1]),
                      inner=10 if n == 1 else 1)
            bound, by = chip_smoke.gf_apply_bound(
                n, geo.d, mat.shape[0], s, table.numel())
            r.update(shape=[n, geo.d, s], rows=int(mat.shape[0]),
                     decode=decode, bound_ms=bound, bound_by=by)
            key = f"gf_apply_{n}x{geo.d}" + ("_decode" if decode else "")
            results[key] = r
            print(f"gf_apply [{n}, {geo.d}, {s}] -> [{n}, {mat.shape[0]}, "
                  f"{s}]{' (decode)' if decode else ''}: old "
                  f"{r['old_ms']:.4f} ms, new {r['new_ms']:.4f} ms (turns "
                  f"{r['turns_ms']}); bound {r['bound_ms']:.4f} ms ({by})",
                  flush=True)
            del x, outs

    if "gf_acc" in old:
        enc = matrix.build_encode_matrix(g.d, g.p)
        table = {k: gf_kernel.to_device_matrix(enc[g.d:, :k], dev)
                 for _, k in K2_SHAPES}
        s = g.chunk
        for n, k in K2_SHAPES:
            x = torch.randint(0, 256, (n, k, s), generator=gen,
                              dtype=torch.uint8, device=dev)
            outs = [torch.empty((n, 8 * g.p, s), dtype=torch.int16, device=dev)
                    for _ in range(2)]
            acc(old["gf_acc"], table[k], x, outs[0])
            acc(new["gf_acc"], table[k], x, outs[1])
            assert torch.equal(outs[0], outs[1]), (
                f"K2 [{n}, {k}]: designs differ")
            r = turns(lambda: acc(old["gf_acc"], table[k], x, outs[0]),
                      lambda: acc(new["gf_acc"], table[k], x, outs[1]),
                      inner=10 if n == 1 else 1)
            nbytes = n * k * s + n * 8 * g.p * s * 2 + g.p * k * 8
            ops = 2 * (8 * g.p) * (8 * k) * n * s
            r.update(shape=[n, k, s],
                     bound_ms=max(nbytes / hbm, ops / int8) * 1e3)
            results[f"gf_acc_{n}x{k}"] = r
            print(f"gf_acc [{n}, {k}, {s}]: old {r['old_ms']:.3f} ms, new "
                  f"{r['new_ms']:.3f} ms (turns {r['turns_ms']}); bound "
                  f"{r['bound_ms']:.3f} ms", flush=True)
            del x, outs

    # the reduce-and-pack against the torch ops of the tp path it replaced,
    # at config 5: 8 parts, tp = 4 partials of int16 [8, 48, 4 MiB]
    kb = g.d // chip_smoke.TP
    enc = matrix.build_encode_matrix(g.d, g.p)
    x = torch.randint(0, 256, (chip_smoke.ACC_PARTS, g.d, g.chunk),
                      generator=gen, dtype=torch.uint8, device=dev)
    partials = [gf_kernel.accumulate(
        gf_kernel.to_device_matrix(enc[g.d:, t * kb:(t + 1) * kb], dev),
        x[:, t * kb:(t + 1) * kb].contiguous())
        for t in range(chip_smoke.TP)]
    want = gf_kernel.apply_matrix(gf_kernel.to_device_matrix(enc[g.d:], dev),
                                  x)
    del x
    assert torch.equal(gf_kernel.reduce_pack(partials), want)
    assert torch.equal(gf_kernel.reduce_pack_plain(partials), want)

    def torch_ops():  # in place into the first partial, as the tp path did
        total = partials[0]
        for q in partials[1:]:
            total.add_(q)
        return gf_kernel.pack_acc(total)

    ms = {"torch_ops": [], "kernel": []}
    for which in ("torch_ops", "kernel", "kernel", "torch_ops"):
        fn = torch_ops if which == "torch_ops" else (
            lambda: gf_kernel.reduce_pack(partials))
        ms[which].append(chip_smoke.time_cuda(torch, fn))
    r8, s = 8 * g.p, g.chunk
    n = chip_smoke.ACC_PARTS
    r = {"torch_ops_ms": statistics.median(ms["torch_ops"]),
         "kernel_ms": statistics.median(ms["kernel"]), "turns_ms": ms,
         "shape": [chip_smoke.TP, n, r8, s],
         "bound_ms": (chip_smoke.TP * n * r8 * s * 2 + n * g.p * s)
         / hbm * 1e3}
    results["gf_acc_pack"] = r
    print(f"gf_acc_pack of {chip_smoke.TP} partials [{n}, {r8}, {s}]: torch "
          f"ops {r['torch_ops_ms']:.3f} ms, kernel {r['kernel_ms']:.3f} ms "
          f"(turns {ms}); bound {r['bound_ms']:.3f} ms", flush=True)
    print(smi, flush=True)
    print(json.dumps({"device": smi, "turns": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
