"""A cell at a tiny size on the CPU, on the port's ``torch`` backend (the
kernels' plain versions): the rehearsal of a chip run, for the tests.

The sizes shrink (4 KiB chunks, objects of a few parts, a 4 MiB blob, at
most three clients); every code path of the run stays the same.  The
device block of the result says ``cpu``: nothing here is a device number.
"""

from __future__ import annotations

import time
import types
from typing import Optional

from gpubench import manifest
from gpubench import run as bench_run

#: the tiny sizes: 4 KiB chunks and objects of five parts and a tail
CHUNK_LOG2 = 12
BLOB_BYTES = (4 << 20) + 4099
SMALL_OBJECT = 3000


def tiny(bench: dict, workload: str, root: str = manifest.ROOT
         ) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell ``workload``, cut to the
    tiny sizes."""
    cell, config, traffic = manifest.cell(bench, workload, root)
    part = config["data"] << CHUNK_LOG2
    config = dict(config, chunk_size_log2=CHUNK_LOG2,
                  object_bytes=min(config["object_bytes"], 5 * part + 777))
    traffic = dict(traffic, blob_bytes=BLOB_BYTES,
                   clients=min(traffic["clients"], 3), warmup=1)
    if "object_bytes" in traffic:
        traffic["object_bytes"] = SMALL_OBJECT
    return cell, config, traffic


def run_tiny(workload: str, seed: int, seconds: float = 1.0,
             trace: int = 0, fault: Optional[str] = None,
             root: str = manifest.ROOT) -> tuple[dict, list[str]]:
    """One tiny run: ``(result line, stderr lines)`` as ``run.py`` would
    print them."""
    bench = manifest.load(root)
    cell, config, traffic = tiny(bench, workload, root)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace,
                                 fault=fault)
    return bench_run.measure(bench, cell, config, traffic, args,
                             time.monotonic(), root=root, backend="torch",
                             device="cpu")
