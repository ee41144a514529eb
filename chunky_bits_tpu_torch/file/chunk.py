"""The unit of placement: a content hash plus the locations holding it
(the port of ``chunky_bits_tpu/file/chunk.py``).

Wire format, as the reference's (hash flattened):

    sha256: <hex>
    locations: [<location string>, ...]

and the optional per-chunk block-digest tree that damage localization
reads, written when the writer's ``repair_block_bytes`` is set:

    blocks: {size: <block bytes>, sha256: [<hex>, ...]}

References without the key parse, verify and repair as before.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

from chunky_bits_tpu_torch.errors import SerdeError
from chunky_bits_tpu_torch.file.hashing import AnyHash
from chunky_bits_tpu_torch.file.location import Location


@dataclass(frozen=True)
class BlockDigests:
    """Per-chunk damage-localization tree: one sha256 per fixed-size
    block of the chunk's content (last block may run short).  A content
    property like the chunk hash — identical across replicas — so it
    lives on the chunk, not on any location."""

    size: int  # block size in bytes (> 0)
    digests: tuple[bytes, ...]  # 32-byte sha256 per block, in order

    def __post_init__(self) -> None:
        if self.size <= 0:
            raise SerdeError("block size must be > 0")
        if not self.digests:
            raise SerdeError("block digests must be non-empty")
        if any(len(d) != 32 for d in self.digests):
            raise SerdeError("block digests must be 32 bytes each")

    @classmethod
    def from_buf(cls, data, size: int) -> "BlockDigests":
        """Digest tree of ``data`` (any buffer) at block ``size``."""
        view = memoryview(data)
        digests = [
            hashlib.sha256(view[off: off + size]).digest()
            for off in range(0, max(len(view), 1), size)
        ]
        return cls(size=int(size), digests=tuple(digests))

    def covers(self, length: int) -> bool:
        """True when this tree describes a buffer of ``length`` bytes
        (block count matches — the localization precondition)."""
        blocks = max((length + self.size - 1) // self.size, 1)
        return len(self.digests) == blocks

    def damaged_ranges(self, data) -> Optional[list[tuple[int, int]]]:
        """Merged ``(start, length)`` ranges of ``data`` whose blocks
        mismatch this tree, or ``None`` when localization does not apply
        (length mismatch — e.g. a truncated replica, whose damage extent
        the tree cannot bound).  ``[]`` means every block matches."""
        view = memoryview(data)
        if not self.covers(len(view)):
            return None
        out: list[tuple[int, int]] = []
        for bi, digest in enumerate(self.digests):
            start = bi * self.size
            block = view[start: start + self.size]
            if hashlib.sha256(block).digest() == digest:
                continue
            if out and out[-1][0] + out[-1][1] == start:
                prev = out.pop()
                out.append((prev[0], prev[1] + len(block)))
            else:
                out.append((start, len(block)))
        return out

    def verify_range(self, data, start: int) -> Optional[bool]:
        """Check ``data`` (bytes read at chunk offset ``start``) against
        the tree: ``True``/``False`` when the range is block-aligned and
        block-sized (so each covered block is wholly present), ``None``
        when the tree cannot judge it (unaligned, or the range runs past
        the covered blocks without being the short tail)."""
        view = memoryview(data)
        if start % self.size != 0 or not view.nbytes:
            return None
        first = start // self.size
        blocks = (view.nbytes + self.size - 1) // self.size
        if first + blocks > len(self.digests):
            return None
        if view.nbytes % self.size and first + blocks != len(self.digests):
            return None  # short middle read: not a whole-block range
        for bi in range(blocks):
            off = bi * self.size
            block = view[off: off + self.size]
            if hashlib.sha256(block).digest() != self.digests[first + bi]:
                return False
        return True

    def to_obj(self) -> dict:
        return {"size": self.size,
                "sha256": [d.hex() for d in self.digests]}

    @classmethod
    def from_obj(cls, obj: object) -> Optional["BlockDigests"]:
        """Lenient parse: anything malformed reads as None (no tree) —
        a damaged/foreign ``blocks`` stanza must degrade the chunk to
        whole-chunk repair, never brick parsing of its reference."""
        if not isinstance(obj, dict):
            return None
        try:
            size = int(obj["size"])
            digests = tuple(bytes.fromhex(h) for h in obj["sha256"])
            return cls(size=size, digests=digests)
        except (KeyError, TypeError, ValueError, SerdeError):
            return None


@dataclass
class Chunk:
    hash: AnyHash
    locations: list[Location] = field(default_factory=list)
    #: optional block-digest tree for damage localization (see module
    #: docstring); None on references written before the tunable, or
    #: when the chunk is no longer than one block
    blocks: Optional[BlockDigests] = None

    def cache_key(self) -> "bytes | None":
        """Key for the content-addressed read cache: the raw sha256
        digest, or None for any future non-sha256 algorithm (those
        chunks simply bypass the cache rather than risk a key clash
        across hash domains)."""
        if self.hash.algorithm != "sha256":
            return None
        return self.hash.value.digest

    def to_obj(self) -> dict:
        obj = {
            self.hash.algorithm: self.hash.value.hex(),
            "locations": [str(loc) for loc in self.locations],
        }
        if self.blocks is not None:
            obj["blocks"] = self.blocks.to_obj()
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "Chunk":
        if not isinstance(obj, dict):
            raise SerdeError(f"chunk must be a mapping, got {type(obj)}")
        hash_ = None
        for algo in ("sha256",):
            if algo in obj:
                hash_ = AnyHash.parse(f"{algo}-{obj[algo]}")
                break
        if hash_ is None:
            raise SerdeError(f"chunk has no recognized hash key: {obj}")
        locations = [Location.parse(s) for s in obj.get("locations", [])]
        blocks = (BlockDigests.from_obj(obj["blocks"])
                  if "blocks" in obj else None)
        return cls(hash=hash_, locations=locations, blocks=blocks)
