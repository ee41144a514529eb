"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
#: the checkout's root: the directory that holds ``BENCHMARK.json``
ROOT = os.path.dirname(HERE)


class ManifestError(Exception):
    pass


def load(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as err:
        raise ManifestError(f"cannot read {path}: {err}") from err


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise ManifestError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as err:
        raise ManifestError(f"cannot read {path}: {err}") from err


def cell(manifest: dict, workload: str, root: str = ROOT
         ) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of the cell named ``workload``."""
    entry = _named(manifest["workloads"], workload, "workload")
    cfg = _named(manifest["configs"], entry["config"], "config")
    config = _json(os.path.join(root, cfg["file"]))
    traffic = _json(os.path.join(root, "gpubench", "traffic",
                                 entry["traffic"] + ".json"))
    return entry, config, traffic


def metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    with ``--trace 0``, the per-layer ones with ``--trace 1``."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload])
            and ("workloads" in m or m["moves"] in moved)]


def reader(name: str, root: str = ROOT) -> Callable[[object],
                                                    Optional[float]]:
    """The ``read(run)`` function of ``gpubench/metrics/<name>.py``."""
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    mod_name = "gpubench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except OSError as err:
        raise ManifestError(f"no reader {path}: {err}") from err
    return mod.read
