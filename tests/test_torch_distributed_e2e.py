"""Multi-process e2e against the port: the mirror of
``tests/test_distributed_e2e.py``.

Storage nodes as separate OS processes (``tests/node_server.py``), a node
death as SIGKILL, a degraded read of the port's cluster over the surviving
sockets, and resilver restoring full redundancy onto the remaining nodes.
7 nodes for a 3+2 profile, so a crash leaves shard-free survivors to take
the rebuilt shards.  The cluster names no backend, so the CPU run sets
``CHUNKY_BITS_TORCH_BACKEND=torch``.
"""

import asyncio
import os
import signal
import sys

import numpy as np
import pytest
import torch

from chunky_bits_tpu_torch.cluster.cluster import Cluster
from chunky_bits_tpu_torch.file.file_part import FileIntegrity
from chunky_bits_tpu_torch.utils import aio
from tests.test_torch_file import bounded


@pytest.fixture(autouse=True)
def torch_default(monkeypatch):
    """The clusters name no backend: on the CPU the default is ``torch``,
    with one intra-op thread (tiny applies; spinning workers would starve
    the other test processes)."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


async def _spawn_node():
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.join(REPO, "tests", "node_server.py"),
        REPO, stdout=asyncio.subprocess.PIPE)
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), 30)
        assert line.startswith(b"PORT "), line
    except BaseException:
        proc.kill()
        await proc.wait()
        raise
    return proc, int(line.split()[1])


def test_node_process_crash_degraded_read_and_resilver(tmp_path):
    payload = np.random.default_rng(77).bytes(150_000)

    async def run() -> None:
        nodes = []
        try:
            for _ in range(7):
                nodes.append(await _spawn_node())
            (tmp_path / "metadata").mkdir()
            cluster = Cluster.from_obj({
                "destinations": [
                    {"location": f"http://127.0.0.1:{port}/"}
                    for _, port in nodes],
                "metadata": {"type": "path", "format": "yaml",
                             "path": str(tmp_path / "metadata")},
                "profiles": {"default": {"data": 3, "parity": 2,
                                         "chunk_size": 12}},
            })
            await cluster.write_file(
                "obj", aio.BytesReader(payload),
                cluster.get_profile(None))

            async def read_back() -> bytes:
                reader = await cluster.read_file("obj")
                out = []
                while True:
                    piece = await reader.read(1 << 16)
                    if not piece:
                        break
                    out.append(piece)
                return b"".join(out)

            assert await read_back() == payload

            # a real node crash: SIGKILL the process holding the first
            # shard of the first part
            first_loc = str(
                (await cluster.get_file_ref("obj")).parts[0]
                .data[0].locations[0])
            victim_port = int(first_loc.split(":")[2].split("/")[0])
            victim = next(pr for pr, port in nodes if port == victim_port)
            victim.send_signal(signal.SIGKILL)
            await victim.wait()

            # degraded read over the surviving sockets (TCP refused on
            # the dead node, reconstruction from the survivors)
            assert await read_back() == payload

            ref = await cluster.get_file_ref("obj")
            vrep = await ref.verify()
            assert vrep.integrity() == FileIntegrity.DEGRADED

            # resilver must place rebuilt shards on shard-free
            # survivors, and the persisted ref must verify Valid
            rrep = await ref.resilver(
                cluster.get_destination(cluster.get_profile(None)))
            assert rrep.new_locations(), "resilver placed nothing"
            assert all(f"127.0.0.1:{victim_port}" not in str(loc)
                       for loc in rrep.new_locations())
            await cluster.write_file_ref("obj", ref)
            ref2 = await cluster.get_file_ref("obj")
            assert (await ref2.verify()).integrity() == FileIntegrity.VALID
            assert await read_back() == payload
        finally:
            for proc, _ in nodes:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()

    bounded(lambda: asyncio.run(run()))
