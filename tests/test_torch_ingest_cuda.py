"""Small concurrent writes through a ``cuda`` cluster merge on the card.

The cuda backend runs one walk at a time, so the cluster's shared encode
batcher holds the writes that arrive while a walk runs and sends them on
together.  Runs only on a card (``-m cuda``).  The digests are held
against hashlib over the data rows and over the parity rows of the JAX
package's numpy coder (on the host; nothing of it runs on the card).
"""

import asyncio
import hashlib

import numpy as np
import pytest

from chunky_bits_tpu.ops.backend import get_coder as jax_coder
from chunky_bits_tpu_torch.cluster.cluster import Cluster
from chunky_bits_tpu_torch.ops.backend import get_backend, get_coder
from chunky_bits_tpu_torch.utils import aio

D, P = 10, 4
WRITERS = 16
#: objects each writer writes in a row: the first dispatches, before
#: the writers fall into step, merge fewer parts
ROUNDS = 6
#: one short part of 10 rows of 419,431 bytes each
OBJECT_BYTES = 4 << 20


def _digests(obj: bytes) -> list[bytes]:
    """SHA-256 of the part's d data rows, then its p parity rows."""
    size = -(-len(obj) // D)
    rows = np.zeros((1, D, size), dtype=np.uint8)
    rows.reshape(-1)[:len(obj)] = np.frombuffer(obj, dtype=np.uint8)
    parity = jax_coder(D, P, "numpy").encode_batch(rows)
    return [hashlib.sha256(r).digest()
            for r in np.concatenate([rows[0], parity[0]])]


@pytest.mark.cuda
def test_concurrent_small_writes_merge_on_the_card(tmp_path):
    """16 writers in a closed loop of 4 MiB writes end at 4 or more parts a
    dispatch of the shared batcher, with every shard's digest equal to
    hashlib's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuda backend has no CPU mode")
    dirs = [tmp_path / f"d{i:02d}" for i in range(D + P)]
    for path in dirs + [tmp_path / "meta"]:
        path.mkdir()
    cluster = Cluster.from_obj({
        "destinations": [{"location": str(path)} for path in dirs],
        "metadata": {"type": "path", "format": "yaml",
                     "path": str(tmp_path / "meta")},
        "profiles": {"default": {"data": D, "parity": P, "chunk_size": 20}},
        "tunables": {"backend": "cuda"},
    })
    rng = np.random.default_rng(19)
    objects = [rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
               for _ in range(WRITERS)]

    async def drive():
        writer = cluster.get_file_writer(cluster.get_profile())
        writer = writer.with_destination(None)
        batcher = writer.encode_batcher()

        async def rounds(obj):
            return [await writer.write(aio.BytesReader(obj))
                    for _ in range(ROUNDS)]

        refs = await asyncio.gather(*(rounds(obj) for obj in objects))
        return batcher, refs

    be = get_backend("cuda")
    device_sha = be.device_sha
    be.device_sha = True
    try:
        batcher, refs = asyncio.run(drive())
    finally:
        be.device_sha = device_sha
    parts = sum(len(ref.parts) for mine in refs for ref in mine)
    counts = (parts, batcher.dispatches, batcher.held)
    assert parts == WRITERS * ROUNDS, counts
    assert parts >= 4 * batcher.dispatches, counts
    assert batcher.held > 0, counts
    for obj, mine in zip(objects, refs):
        want = _digests(obj)
        for ref in mine:
            (part,) = ref.parts
            assert [c.hash.value.digest
                    for c in part.data + part.parity] == want


@pytest.mark.cuda
@pytest.mark.parametrize("device_sha", [True, False])
def test_a_page_locked_batch_walks_unstaged(device_sha, monkeypatch):
    """A batch in the backend's ``host_buffer`` is page-locked and walks
    to the card without staging, over several blocks, to the same parity
    and digests as an ordinary batch and as the JAX package's numpy coder
    with hashlib."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuda backend has no CPU mode")
    be = get_backend("cuda")
    b, s = 7, 4099
    # three blocks of 3, 3 and 1 parts on either route
    monkeypatch.setattr(be, "max_block_bytes", 3 * D * s)
    monkeypatch.setattr(be, "max_fused_block_bytes", 3 * (D + P) * s)
    monkeypatch.setattr(be, "device_sha", device_sha)
    data = np.random.default_rng(19).integers(0, 256, (b, D, s),
                                              dtype=np.uint8)
    pinned = be.host_buffer(data.shape)
    pinned[...] = data
    assert torch.from_numpy(pinned).is_pinned()
    assert not torch.from_numpy(data).is_pinned()
    want = jax_coder(D, P, "numpy").encode_batch(data)
    rows = np.concatenate([data, want], axis=1)
    digests = np.array([[np.frombuffer(hashlib.sha256(r).digest(),
                                       dtype=np.uint8) for r in part]
                        for part in rows])
    mat = get_coder(D, P, "cuda").parity_rows
    for src in (data, pinned):
        assert np.array_equal(be.apply_matrix(mat, src), want)
        parity, got = be.encode_and_hash(mat, src)
        assert np.array_equal(parity, want)
        assert np.array_equal(got, digests)
