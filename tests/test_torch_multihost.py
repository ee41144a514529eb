"""The port's multi-host bootstrap (``chunky_bits_tpu_torch/parallel/
multihost.py``), held against ``chunky_bits_tpu/parallel/multihost.py``.

``init_multihost`` with nothing to join is a single-process no-op and
idempotent, and explicit arguments after that finalize raise;
``partition_parts`` deals the same slices as the JAX package's over a
grid of (total, n, i); the local meshes span the logical devices they are
given.  The two-process case runs this file as a script in two
subprocesses (120 s each): they join one ``gloo`` group over
``tcp://127.0.0.1`` through ``init_multihost``, each encodes its
``partition_parts`` slice of seeded parts (each part made from ``(SEED,
part index)``) through ``encode_step_sharded`` on ``local_mesh(sp=2)``
over ``virtual_devices(2, "cpu")`` (the ``torch`` path), and the
concatenated parity must equal the JAX package's ``NumpyBackend``
oracle byte for byte, each process's checksum its slice's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from chunky_bits_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED = 20261017

#: the two-process encode: parts, geometry and shard bytes
PARTS, D, P, S = 9, 5, 3, 1000


def part_data(index: int) -> np.ndarray:
    """Part ``index`` of the seeded batch, uint8 [D, S]."""
    return np.random.default_rng((SEED, index)).integers(
        0, 256, (D, S), dtype=np.uint8)


@pytest.fixture
def fresh(monkeypatch):
    """A process that has not been finalized yet (the module's one-shot
    flag, restored after the test)."""
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + name, raising=False)


def test_single_process_noop_is_idempotent(fresh):
    from chunky_bits_tpu_torch import parallel

    assert parallel.init_multihost is multihost.init_multihost
    assert multihost.init_multihost() == (0, 1)
    assert multihost.init_multihost() == (0, 1)
    assert multihost.init_multihost(auto=False) == (0, 1)
    assert multihost.partition_parts(10) == (0, 10)
    assert not multihost.dist.is_initialized()


def test_late_explicit_arguments_raise(fresh):
    multihost.init_multihost()
    for kwargs in ({"coordinator_address": "127.0.0.1:1"},
                   {"num_processes": 2}, {"process_id": 1}):
        with pytest.raises(RuntimeError, match="already finalized"):
            multihost.init_multihost(**kwargs)
    assert multihost.init_multihost() == (0, 1)


def test_partial_arguments_and_env_refuse(fresh, monkeypatch):
    with pytest.raises(ValueError, match="go together"):
        multihost.init_multihost("127.0.0.1:1")
    monkeypatch.setenv("CHUNKY_BITS_TORCH_COORDINATOR_ADDRESS",
                       "127.0.0.1:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        multihost.init_multihost()
    # the JAX package's variable never reaches the port
    monkeypatch.delenv("CHUNKY_BITS_TORCH_COORDINATOR_ADDRESS")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("CHUNKY_BITS_TPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert multihost.init_multihost() == (0, 1)


GRID = [(total, n) for total in (0, 1, 2, 7, 16, 255, 256, 1025)
        for n in (1, 2, 3, 4, 7, 8)]


@pytest.mark.parametrize("total,n", GRID,
                         ids=[f"{t}-{n}" for t, n in GRID])
def test_partition_parts_equals_jax(total, n):
    from chunky_bits_tpu.parallel.multihost import \
        partition_parts as jax_partition

    slices = [multihost.partition_parts(total, i, n) for i in range(n)]
    assert slices == [jax_partition(total, i, n) for i in range(n)]
    # contiguous, balanced, covering
    assert slices[0][0] == 0 and slices[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    sizes = [b - a for a, b in slices]
    assert max(sizes) - min(sizes) <= 1
    for bad in (-1, n):
        with pytest.raises(ValueError, match="process_index"):
            multihost.partition_parts(total, bad, n)
        with pytest.raises(ValueError, match="process_index"):
            jax_partition(total, bad, n)


def test_local_meshes_span_the_given_devices():
    from chunky_bits_tpu_torch import parallel
    from chunky_bits_tpu_torch.utils.virtualmesh import virtual_devices

    devices = virtual_devices(4, "cpu")
    mesh = parallel.local_mesh(sp=2, devices=devices)
    assert mesh.shape == {"dp": 2, "sp": 2}
    assert list(mesh.devices.flat) == devices
    assert parallel.local_mesh(devices=devices).shape == {"dp": 4, "sp": 1}
    stripe = parallel.local_stripe_mesh(tp=4, devices=devices)
    assert stripe.shape == {"dp": 1, "tp": 4}
    with pytest.raises(ValueError):
        parallel.local_mesh(dp=3, devices=devices)


def test_local_mesh_without_devices_needs_the_card():
    import torch

    from chunky_bits_tpu_torch.errors import ErasureError

    if torch.cuda.is_available():
        pytest.skip("a card is present: visible_devices() succeeds")
    with pytest.raises(ErasureError, match="CUDA"):
        multihost.local_mesh()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_process_gloo_encode_equals_the_oracle(tmp_path):
    from chunky_bits_tpu.ops import matrix as jmatrix
    from chunky_bits_tpu.ops.backend import NumpyBackend

    address = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHUNKY_BITS_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", address, "2",
         str(rank), str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(2)]
    assert [(r["start"], r["stop"]) for r in reports] == [(0, 5), (5, 9)]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in reports)
    # each rank saw both ranks' control records through the group
    assert reports[0]["gathered"] == reports[1]["gathered"]
    assert [g[0] for g in reports[0]["gathered"]] == [0, 1]
    parity = np.concatenate([np.load(tmp_path / f"rank{r}.npy")
                             for r in range(2)])
    enc = jmatrix.build_encode_matrix(D, P)
    data = np.stack([part_data(i) for i in range(PARTS)])
    want = NumpyBackend().apply_matrix(enc[D:], data)
    assert parity.shape == want.shape == (PARTS, P, S)
    assert np.array_equal(parity, want)
    for r in reports:
        lo, hi = r["start"], r["stop"]
        assert r["checksum"] == int(want[lo:hi].sum(dtype=np.uint64)) \
            & 0xFFFFFFFF


def worker(argv: list[str]) -> int:
    """One process of the two-process encode: join, encode this slice,
    report through the group, write parity and a JSON report."""
    import torch.distributed as dist

    from chunky_bits_tpu_torch.ops import matrix
    from chunky_bits_tpu_torch.parallel import (encode_step_sharded,
                                                init_multihost, local_mesh,
                                                partition_parts)
    from chunky_bits_tpu_torch.utils.virtualmesh import virtual_devices

    address, world, rank, out = argv
    index, count = init_multihost(address, int(world), int(rank),
                                  timeout_s=60)
    try:
        start, stop = partition_parts(PARTS)
        data = np.stack([part_data(i) for i in range(start, stop)])
        mesh = local_mesh(sp=2, devices=virtual_devices(2, "cpu"))
        parity, checksum = encode_step_sharded(
            mesh, matrix.build_encode_matrix(D, P), data)
        gathered = [None] * count
        dist.all_gather_object(gathered, (index, start, stop, checksum))
        np.save(os.path.join(out, f"rank{index}.npy"), parity)
        with open(os.path.join(out, f"rank{index}.json"), "w") as f:
            json.dump({"start": start, "stop": stop, "checksum": checksum,
                       "world": count, "backend": dist.get_backend(),
                       "gathered": gathered}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.exit(worker(sys.argv[2:]))
