"""The port's object codec against the JAX package: writer, reader, verify
and resilver.

The port's ``FileWriteBuilder`` on the ``torch`` backend must reproduce the
JAX package's golden references byte for byte, with the packed kernel off
and on.  Over ``path`` destinations in a temporary directory, each package
must read back what the other wrote, a read must survive deleted chunk
files, and the verify and resilver reports must agree with the JAX
package's on the same damaged tree.  Tolerance 0 throughout.
"""

import asyncio
import os
import shutil
import threading

import pytest
import yaml

import chunky_bits_tpu.file as jfile
from chunky_bits_tpu.utils import aio as jaio
from chunky_bits_tpu_torch.file import (FileReadBuilder, FileReference,
                                        FileWriteBuilder, LocationsDestination)
from chunky_bits_tpu_torch.ops import backend, gf_kernel
from chunky_bits_tpu_torch.ops.batching import (EncodeHashBatcher,
                                                ReconstructBatcher)
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
from chunky_bits_tpu_torch.utils import aio
from tests.golden import generate as gen

#: seconds a test may wait on the event loop or the host threads: a hang
#: fails the test instead of cutting the suite
TIMEOUT = 60


def bounded(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread, failed after ``timeout`` seconds."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as err:
            box["err"] = err

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), f"still running after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


def run(coro):
    return bounded(lambda: asyncio.run(coro))


def golden(name: str) -> str:
    with open(os.path.join(gen.GOLDEN_DIR, f"{name}.yaml")) as f:
        return f.read()


#: the generator's payloads and geometries (tests/golden/generate.py)
GOLDENS = {
    "void_small": (100_000, 1, 1 << 14, 3, 2, 0),
    "void_wide": (3 * 10 * (1 << 12) + 777, 2, 1 << 12, 10, 4, 0),
    "block_digests": (100_000, 1, 1 << 14, 3, 2, 4096),
}


@pytest.fixture
def torch_backend(monkeypatch):
    """The registry's ``torch`` backend, its knobs restored after."""
    be = backend.get_backend("torch")
    monkeypatch.setattr(be, "packed", be.packed)
    return be


def count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a: calls.append(a[1].shape) or real(*a))
    return calls


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_writer_reproduces_goldens(monkeypatch, torch_backend, name, packed):
    n, seed, chunk, d, p, blocks = GOLDENS[name]
    torch_backend.packed = packed
    calls = count_calls(monkeypatch, gf_kernel, "apply_matrix_packed_plain")
    ref = run(FileWriteBuilder().with_backend("torch").with_chunk_size(chunk)
              .with_data_chunks(d).with_parity_chunks(p)
              .with_repair_block_bytes(blocks)
              .write(aio.BytesReader(gen.payload(n, seed))))
    assert gen.dump(ref.to_obj()) == golden(name)
    # the full-length parts are inside the packed gate, the tails are not
    assert bool(calls) == packed
    assert all(shape[2] % 256 == 0 for shape in calls)


def test_staged_batched_mmap_ingest_reproduces_golden(tmp_path,
                                                      torch_backend):
    """A local source through ``view_parts`` (read-only page-cache views),
    sub-blocks of one part merged by a shared batcher that runs on its own
    host pipeline, the packed kernel on: the same bytes."""
    n, seed, chunk, d, p, _ = GOLDENS["void_wide"]
    src = tmp_path / "src.bin"
    src.write_bytes(gen.payload(n, seed))
    torch_backend.packed = True
    pipeline = HostPipeline(threads=2)

    async def main():
        batcher = EncodeHashBatcher(backend="torch", max_batch=4,
                                    host_pipeline=pipeline)
        reader = aio.FileReader(str(src))
        try:
            ref = await (FileWriteBuilder().with_backend("torch")
                         .with_chunk_size(chunk).with_data_chunks(d)
                         .with_parity_chunks(p).with_batch_parts(4)
                         .with_stage_parts(1).with_encode_batcher(batcher)
                         .with_host_pipeline(pipeline).write(reader))
        finally:
            await reader.close()
            await batcher.aclose()
        return ref, batcher

    try:
        ref, batcher = run(main())
    finally:
        bounded(pipeline.close)
    assert gen.dump(ref.to_obj()) == golden("void_wide")
    assert 1 <= batcher.dispatches <= 4
    assert "encode" in {s.stage for s in pipeline.stats().stages}


def make_dirs(root, n):
    dirs = [root / f"d{i}" for i in range(n)]
    for path in dirs:
        path.mkdir(parents=True)
    return [str(path) for path in dirs]


def payload(n=5 * 3 * 4096 + 1234, seed=7):
    return gen.payload(n, seed)


async def port_write(dirs, data):
    return await (FileWriteBuilder().with_backend("torch")
                  .with_destination(LocationsDestination(dirs))
                  .with_chunk_size(4096).with_data_chunks(3)
                  .with_parity_chunks(2).write(aio.BytesReader(data)))


async def jax_write(dirs, data):
    return await (jfile.FileWriteBuilder().with_backend("numpy")
                  .with_destination(jfile.LocationsDestination(dirs))
                  .with_chunk_size(4096).with_data_chunks(3)
                  .with_parity_chunks(2).write(jaio.BytesReader(data)))


def rebased(obj, old, new):
    """A reference's object form with every location under ``old`` moved
    under ``new``."""
    return yaml.safe_load(yaml.safe_dump(obj).replace(old, new))


def test_round_trip_across_packages(tmp_path):
    data = payload()
    port_dirs = make_dirs(tmp_path / "port", 5)
    jax_dirs = make_dirs(tmp_path / "jax", 5)

    async def main():
        ours = await port_write(port_dirs, data)
        theirs = await jax_write(jax_dirs, data)
        # first-N placement is deterministic: the refs differ only in root
        assert rebased(ours.to_obj(), str(tmp_path / "port"),
                       str(tmp_path / "jax")) == theirs.to_obj()
        jax_ref = jfile.FileReference.from_obj(ours.to_obj())
        assert await (jax_ref.read_builder().with_backend("numpy")
                      .read_all()) == data
        port_ref = FileReference.from_obj(theirs.to_obj())
        assert await (port_ref.read_builder().with_backend("torch")
                      .read_all()) == data
        # a seek/take window reads the same bytes through both packages
        window = (port_ref.read_builder().with_backend("torch")
                  .with_seek(5000).with_take(20000))
        assert window.len_bytes() == 20000
        assert await window.read_all() == data[5000:25000]

    run(main())


def damage(ref_obj):
    """Delete data chunk 0 of every part and overwrite the last parity
    chunk of part 0 with other bytes; return the damaged paths."""
    deleted, corrupt = [], None
    for i, part in enumerate(ref_obj["parts"]):
        path = part["data"][0]["locations"][0]
        os.remove(path)
        deleted.append(path)
        if i == 0:
            corrupt = part["parity"][-1]["locations"][0]
            with open(corrupt, "r+b") as f:
                f.write(b"\xff" * 16)
    return deleted, corrupt


def test_degraded_read_after_deleted_chunks(tmp_path):
    data = payload()
    dirs = make_dirs(tmp_path, 5)

    async def main():
        ref = await port_write(dirs, data)
        deleted, _ = damage(ref.to_obj())
        batcher = ReconstructBatcher(backend="torch")
        got = await (FileReadBuilder(ref).with_backend("torch")
                     .with_batcher(batcher).read_all())
        await batcher.aclose()
        assert got == data
        # every part lost a data chunk, all with one erasure pattern or two
        assert 1 <= batcher.dispatches <= len(deleted)
        assert batcher.groups >= 1

    run(main())


def test_cache_is_not_yet_ported(tmp_path):
    """The chunk cache is ported: a read builder with a cache reads an
    empty reference, and a real object twice, the second time from the
    cache (``tests/test_torch_chunk_cache.py`` holds the rest)."""
    from chunky_bits_tpu_torch.file import ChunkCache

    async def main():
        empty = FileReference(length=0, parts=[])
        assert await FileReadBuilder(empty).with_cache(
            ChunkCache(1 << 20)).read_all() == b""
        dirs = [str(tmp_path / f"d{i}") for i in range(3)]
        for d in dirs:
            os.mkdir(d)
        payload = bytes(range(256)) * 40
        ref = await FileWriteBuilder().with_backend("torch") \
            .with_destination(LocationsDestination(dirs)) \
            .with_chunk_size(4096).with_data_chunks(2) \
            .with_parity_chunks(1).write(aio.BytesReader(payload))
        cache = ChunkCache(1 << 20)
        builder = FileReadBuilder(ref).with_backend("torch") \
            .with_cache(cache)
        assert await builder.read_all() == payload
        hits = cache.hits
        assert await builder.read_all() == payload
        assert cache.hits > hits

    run(main())


def relative_report(text, root):
    return text.replace(str(root), "<root>")


def test_verify_and_resilver_agree_with_jax(tmp_path):
    data = payload()
    tree = tmp_path / "port"
    dirs = make_dirs(tree, 5)

    async def main():
        ref = await port_write(dirs, data)
        damage(ref.to_obj())
        shutil.copytree(tree, tmp_path / "jax")
        jax_obj = rebased(ref.to_obj(), str(tree), str(tmp_path / "jax"))
        jax_ref = jfile.FileReference.from_obj(jax_obj)
        jax_dest = jfile.LocationsDestination(
            [d.replace(str(tree), str(tmp_path / "jax")) for d in dirs])

        ours = await ref.verify()
        theirs = await jax_ref.verify()
        assert str(ours) == str(theirs)
        assert int(ours.integrity()) == int(theirs.integrity())
        assert (relative_report(ours.display_full_report(), tree)
                == relative_report(theirs.display_full_report(),
                                   tmp_path / "jax"))
        assert len(ours.unhealthy_chunks()) == len(ref.parts) + 1
        assert len(ours.invalid_locations()) == 1

        resilvered = await ref.resilver(LocationsDestination(dirs),
                                        backend="torch")
        jax_resilvered = await jax_ref.resilver(jax_dest, backend="numpy")
        assert str(resilvered) == str(jax_resilvered)
        assert (relative_report(resilvered.display_full_report(), tree)
                == relative_report(jax_resilvered.display_full_report(),
                                   tmp_path / "jax"))
        assert len(resilvered.new_locations()) == len(ref.parts) + 1
        # the repaired tree verifies clean and reads back through both
        assert (await ref.verify()).is_ideal()
        assert await ref.read_builder().with_backend("torch").read_all() \
            == data
        again = jfile.FileReference.from_obj(ref.to_obj())
        assert (await again.verify()).is_ideal()

    run(main())
