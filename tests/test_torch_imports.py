"""Host paths of the port load no torch, as the JAX package's load no jax.

Each module of ``chunky_bits_tpu/`` is imported in a fresh interpreter and
must leave ``jax`` out of ``sys.modules``: that calibrates the test against
the reference.  Each module of the port outside its device plane
(``DEVICE_PLANE``) must then leave ``torch`` out, and every module of the
device plane too: a host module may import them only where a device
backend is built or called.  The modules of a package are imported one
after another in one interpreter (``_scan``), which starts again after
any module that loaded something it should not, so a fault is pinned on
the module that brought it in.  The CLI's host commands (``config-info``,
``ls`` of a path cluster) run under ``python -X importtime``, whose report
must name no torch module.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's device plane, by path inside the package: these may import
#: torch at load, and no host module may import them at load
DEVICE_PLANE = (
    "ops/cuda_backend.py",
    "ops/gf_kernel.py",
    "ops/sha256.py",
    "ops/mesh_backend.py",
    "ops/dispatch_pipeline.py",
    "parallel/",
    "utils/virtualmesh.py",
)

#: the JAX package's modules whose port has another name
COUNTERPART = {
    "ops/jax_backend.py": "ops/cuda_backend.py",
    "ops/pallas_kernels.py": "ops/gf_kernel.py",
    "ops/bitplane.py": "ops/gf_kernel.py",
    "ops/sha256_jax.py": "ops/sha256.py",
}

#: seconds one scan interpreter may take
SCAN_TIMEOUT = 300

#: imports the modules named in argv[2] in order and prints, as JSON, the
#: forbidden modules that each one left in ``sys.modules`` (argv[1] and its
#: submodules, and the names in argv[3] and theirs); it stops after the
#: first module that left one.  A ``__main__`` module runs as ``-m``
#: would run it, with ``--help``.
_RUNNER = r"""
import contextlib, importlib, io, json, runpy, sys

heavy, mods, banned = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
prefixes = tuple(n + "." for n in [heavy] + banned)
out = {}
for m in mods:
    if m.endswith(".__main__"):
        saved, sys.argv = sys.argv, [m, "--help"]
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                runpy.run_module(m, run_name="__main__")
            except SystemExit:
                pass
        sys.argv = saved
    else:
        importlib.import_module(m)
    out[m] = sorted(n for n in sys.modules
                    if n == heavy or n in banned or n.startswith(prefixes))
    if out[m]:
        break
print(json.dumps(out))
"""


def _modules(pkg: str) -> dict:
    """``{path inside the package: module name}`` for every module."""
    base = os.path.join(ROOT, pkg)
    found = {}
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(("_", ".")))
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), base)
            parts = [pkg] + rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts.pop()
            found[rel.replace(os.sep, "/")] = ".".join(parts)
    return found


REFERENCE = _modules("chunky_bits_tpu")
PORT = _modules("chunky_bits_tpu_torch")


def _device(rel: str) -> bool:
    return any(rel == d or (d.endswith("/") and rel.startswith(d))
               for d in DEVICE_PLANE)


PORT_HOST = {rel: m for rel, m in PORT.items() if not _device(rel)}
PORT_DEVICE = sorted(m for rel, m in PORT.items() if _device(rel))


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _scan(heavy: str, modules: list, banned=()) -> dict:
    """``{module: forbidden modules it left loaded}`` for each module, in
    as few interpreters as the faults allow."""
    results: dict = {}
    todo = list(modules)
    while todo:
        proc = subprocess.run(
            [sys.executable, "-c", _RUNNER, heavy, json.dumps(todo),
             *banned],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=SCAN_TIMEOUT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        results.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        todo = [m for m in todo if m not in results]
    return results


@pytest.fixture(scope="module")
def reference_scan():
    return _scan("jax", list(REFERENCE.values()))


@pytest.fixture(scope="module")
def port_scan():
    return _scan("torch", list(PORT_HOST.values()), PORT_DEVICE)


@pytest.mark.parametrize("rel", sorted(REFERENCE))
def test_reference_module_leaves_jax_out(rel, reference_scan):
    assert reference_scan[REFERENCE[rel]] == []


@pytest.mark.parametrize("rel", sorted(PORT_HOST))
def test_port_host_module_leaves_torch_out(rel, port_scan, reference_scan):
    ref = REFERENCE.get(rel)
    if ref is not None and reference_scan[ref]:
        pytest.skip(f"the JAX package's {ref} loads jax at import")
    assert port_scan[PORT_HOST[rel]] == [], (
        f"importing {PORT_HOST[rel]} loaded torch or the device plane")


def test_every_reference_module_has_a_host_or_device_counterpart():
    for rel in REFERENCE:
        theirs = COUNTERPART.get(rel, rel)
        assert theirs in PORT, f"{rel} has no counterpart {theirs} in the port"
        assert (theirs in PORT_HOST) != _device(theirs)


def test_device_plane_names_existing_modules():
    for entry in DEVICE_PLANE:
        assert any(rel == entry or rel.startswith(entry) for rel in PORT), \
            entry


def _importtime(*argv, cwd=ROOT):
    """Run ``python -X importtime -m chunky_bits_tpu_torch ARGV``; return
    the process and the names of the modules it imported."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "chunky_bits_tpu_torch",
         *argv],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=120)
    names = [line.rsplit("|", 1)[1].strip()
             for line in proc.stderr.splitlines()
             if line.startswith("import time:") and "|" in line]
    return proc, names


def _torch_modules(names):
    return [n for n in names if n == "torch" or n.startswith("torch.")]


def test_config_info_loads_no_torch():
    proc, names = _importtime("config-info", "--json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout)["default_destination"]["type"] == "void"
    assert "chunky_bits_tpu_torch.cli.main" in names
    assert _torch_modules(names) == []


def test_ls_of_a_path_cluster_loads_no_torch(tmp_path):
    import yaml

    meta = tmp_path / "meta"
    (meta / "sub").mkdir(parents=True)
    for name in ("a", "sub/b"):
        (meta / name).write_text("parts: []\nlength: 0\n")
    disk = tmp_path / "disk"
    disk.mkdir()
    cluster = tmp_path / "cluster.yaml"
    cluster.write_text(yaml.safe_dump({
        "destinations": [{"location": str(disk)}],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": 3, "parity": 2}},
    }))
    proc, names = _importtime("ls", "-r", f"{cluster}#.")
    assert proc.returncode == 0, proc.stderr[-3000:]
    theirs = subprocess.run(
        [sys.executable, "-m", "chunky_bits_tpu", "ls", "-r", f"{cluster}#."],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert theirs.returncode == 0, theirs.stderr[-3000:]
    assert proc.stdout == theirs.stdout
    assert {"a", "sub/b"} <= set(proc.stdout.split())
    assert _torch_modules(names) == []


#: the host routes of ``ops.backend`` that must run without torch
_HOST_ROUTES = r"""
import sys
import numpy as np
from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops.backend import (
    KNOWN_CODES, NumpyBackend, canonical_backend_name, get_backend,
    get_coder, row_hasher)

assert canonical_backend_name("jax:dp2,tp4") == "cuda:dp2,tp4"
assert KNOWN_CODES == ("rs", "pm-msr")
for bad in [("no-such-code", 3, 2), ("pm-msr", 5, 3), ("pm-msr", 1, 2)]:
    try:
        get_coder(bad[1], bad[2], "numpy", code=bad[0])
    except ErasureError:
        pass
    else:
        raise AssertionError(bad)
data = np.arange(3 * 64, dtype=np.uint8).reshape(1, 3, 64)
parity = get_coder(3, 2, "numpy").encode_batch(data)
assert np.array_equal(parity, get_coder(3, 2, "native").encode_batch(data))
assert np.array_equal(parity, NumpyBackend().apply_matrix(
    get_coder(3, 2, "numpy").parity_rows, data))
digests = np.empty((1, 3, 32), dtype=np.uint8)
row_hasher()(data, digests)
print(sorted(n for n in sys.modules if n == "torch" or n.startswith("torch.")))
"""


def test_backend_host_routes_load_no_torch():
    proc = subprocess.run([sys.executable, "-c", _HOST_ROUTES], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_default_and_cuda_backends_still_raise_without_a_card(monkeypatch):
    import torch

    from chunky_bits_tpu_torch.errors import ErasureError
    from chunky_bits_tpu_torch.ops.backend import get_backend

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda backend builds")
    monkeypatch.delenv("CHUNKY_BITS_TORCH_BACKEND", raising=False)
    for name in (None, "cuda", "jax", "auto"):
        with pytest.raises(ErasureError, match="CUDA is not available"):
            get_backend(name)
