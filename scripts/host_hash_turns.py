#!/usr/bin/env python3
"""Time BASELINE.md config 2's object ingest on the ``cuda`` backend with
each host row hasher, in turns, on one NVIDIA card.

    python3 scripts/host_hash_turns.py [--parts 1024]

The ingest is ``chip_smoke.phase_object_ingest``: ``parts`` full parts of
d=10 p=4 with 1 MiB chunks (1024: a 10 GiB stream) and a 777-byte tail
through ``FileWriteBuilder`` over the void destination, parity by K1 on the
card and the SHA-256 of every data and parity row on the host.  Four
arrangements run in turns (A B C D D C B A), each preceded by a short warm
ingest:

* A ``native``, shared: the native SHA-NI row hasher, and the writer on
  the process-shared host pipeline (the writer's default, where the
  ``cuda`` backend's hash jobs run too);
* B ``hashlib``, shared: the hashlib row hasher, the same pipeline;
* C ``native``, own: the writer on a ``HostPipeline`` of its own (as
  ``chip_smoke.py``'s object phases run it), the hash jobs on the shared
  one;
* D ``hashlib``, own.

Every run's file reference must equal the first one's.  Prints the card's
name and power limit, a line per run (GiB/s end to end, the shared
pipeline's hash busy seconds and hashed bytes), and one JSON object last.
Imports nothing of JAX or of ``chunky_bits_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo's smoke script: shared helpers)

ORDER = ("A", "B", "C", "D", "D", "C", "B", "A")
ARRANGEMENTS = {"A": ("native", "shared"), "B": ("hashlib", "shared"),
                "C": ("native", "own"), "D": ("hashlib", "own")}


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parts", type=int, default=chip_smoke.OBJECT_PARTS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("host_hash_turns: CUDA is not available", file=sys.stderr)
        return 2
    from chunky_bits_tpu_torch.ops import backend, cpu_backend
    from chunky_bits_tpu_torch.parallel.host_pipeline import (
        HostPipeline, get_host_pipeline)

    smi = chip_smoke.phase_device(torch)
    be = backend.get_backend("cuda")  # builds the kernels
    assert be.name == "cuda"
    hashers = {"native": backend._hash_rows_native,
               "hashlib": backend._hash_rows_hashlib}
    assert backend.row_hasher_engine() == "native"
    print(f"host codec tiers {cpu_backend.native_tiers()}", flush=True)
    blob = np.random.default_rng(chip_smoke.SEED + 4).integers(
        0, 256, chip_smoke.BLOB_BYTES, dtype=np.uint8).tobytes()
    shared = get_host_pipeline()
    total = args.parts * chip_smoke.D * chip_smoke.CHUNK + chip_smoke.TAIL

    def hash_stage() -> tuple:
        st = {x.stage: x for x in shared.stats().stages}
        h = st.get("hash")
        return (h.busy_s, h.nbytes) if h is not None else (0.0, 0)

    runs, first = [], None
    for tag in ORDER:
        hasher, where = ARRANGEMENTS[tag]
        backend._ROW_HASHER = hashers[hasher]
        pipe = shared if where == "shared" else HostPipeline()
        try:
            chip_smoke.phase_object_ingest_warm(blob, pipe)
            busy0 = hash_stage()
            t0 = time.perf_counter()
            ref, _batcher = chip_smoke.phase_object_ingest(
                blob, pipe, f"{tag} ({hasher}, {where})", None, args.parts)
            dt = time.perf_counter() - t0
            busy1 = hash_stage()
        finally:
            if pipe is not shared:
                pipe.close()
        obj = ref.to_obj()
        if first is None:
            first = obj
        assert obj == first, f"run {tag} wrote another reference"
        run = {"tag": tag, "hasher": hasher, "writer_pipeline": where,
               "seconds": dt, "gib_s": total / dt / 2**30,
               "hash_busy_s": busy1[0] - busy0[0],
               "hashed_bytes": busy1[1] - busy0[1]}
        runs.append(run)
        print(f"{tag}: {hasher}, writer on the {where} pipeline: "
              f"{run['gib_s']:.3f} GiB/s ({dt:.2f} s); hash busy "
              f"{run['hash_busy_s']:.2f} s for "
              f"{run['hashed_bytes'] / 2**30:.2f} GiB", flush=True)
    backend._ROW_HASHER = hashers["native"]
    summary = {tag: statistics.mean(r["gib_s"] for r in runs
                                    if r["tag"] == tag)
               for tag in ARRANGEMENTS}
    print(f"mean GiB/s: {summary}; every reference equal")
    print(smi)
    print(json.dumps({"card": smi, "bytes": total, "runs": runs,
                      "mean_gib_s": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
