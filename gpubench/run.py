"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m gpubench.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  The run needs the cards its cell asks
for: without them it prints no result and exits 3.  It makes its inputs
from ``--seed``, warms up every shape the cell's traffic uses, measures
for ``--seconds``, checks the window's answers against the plain
reference in ``gpubench/reference/``, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checked``, each number compared beside its limit, which also end
standard error.
"""

from __future__ import annotations

import time

_T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: top-level module names that must not be loaded in the process that
#: prints the result: JAX and the JAX package (compared whole, so the
#: port, ``chunky_bits_tpu_torch``, is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "chunky_bits_tpu")

#: the build and kernel caches' directories, at fixed paths inside the
#: checkout (the port's own kernels build into its ``_build/``)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv_compute"}


def process_start() -> float:
    """This process's start on the monotonic clock (the interpreter's
    start-up included), or the harness's import when that is unknown."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return min(time.monotonic() - age, _T_IMPORT)
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_IMPORT


def forbidden_modules() -> list[str]:
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault under the timed path (the "
                         "control and the tests; never the benchmark)")
    args = ap.parse_args(argv)

    from gpubench import manifest

    root = manifest.ROOT
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(root, ".gpubench_cache", sub)
    try:
        bench = manifest.load(root)
        cell, config, traffic = manifest.cell(bench, args.workload, root)
    except (manifest.ManifestError, KeyError) as err:
        print(f"gpubench: {err}", file=sys.stderr)
        return 2

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 3
    result, lines = measure(bench, cell, config, traffic, args, t_process,
                            root=root)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: modules loaded that the benchmark forbids: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    emit(result, lines)
    return 0


def measure(bench: dict, cell: dict, config: dict, traffic: dict, args,
            t_process: float, *, root: str, backend=None,
            device: str = "cuda") -> tuple[dict, list[str]]:
    """Run the cell and build its result line: ``(result, check lines)``."""
    from gpubench import generator, manifest

    run, checked, dev = generator.run_cell(
        cell["name"], config, traffic, args.seed, args.seconds,
        bool(args.trace), t_process, backend=backend, device=device,
        fault=args.fault, root=root)
    trace = bool(args.trace)
    metrics = {}
    for m in manifest.metrics(bench, cell["name"], trace):
        value = manifest.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev["busy_s"] = run.trace["busy_s"] if run.trace else 0.0
        dev["window_s"] = run.window_s
    failing = [name for name, (value, limit) in checked.items()
               if limit is not None and value > limit]
    counted = [v for name, (v, limit) in checked.items() if limit is None]
    ops = run.due()
    result = {
        "correct": not failing and bool(ops) and all(counted),
        "attempted": len(ops),
        "failed": sum(1 for op in ops if not op.ok),
        "metrics": metrics,
        "device": dev,
    }
    if trace and run.trace:
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              run.trace["device_ops"]],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checked"] = {name: {"value": value, "limit": limit}
                         for name, (value, limit) in checked.items()}
    run.notes["window_parts"] = sum(op.parts for op in ops if op.ok and
                                    run.t_start <= op.t1 <= run.t_end)
    lines = [f"gpubench: window {json.dumps(run.notes)} counters "
             f"{json.dumps(run.counters)}"]
    lines += [f"check {name} {value} limit {limit}"
              for name, (value, limit) in checked.items()]
    return result, lines


def emit(result: dict, lines: list[str]) -> None:
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
