"""Content addressing and integrity hashing (the port of
``chunky_bits_tpu/file/hashing.py``).

``Sha256Hash`` with hex serde, and the algorithm-tagged ``AnyHash`` whose
display form ``sha256-<hex>`` is the chunk's file name on every
destination.  hashlib releases the GIL, so the async variants hop to a
thread.
"""

from __future__ import annotations

import asyncio
import hashlib
from dataclasses import dataclass

from chunky_bits_tpu_torch.errors import SerdeError


@dataclass(frozen=True, order=True)
class Sha256Hash:
    digest: bytes  # 32 raw bytes

    def __post_init__(self) -> None:
        if len(self.digest) != 32:
            raise SerdeError("sha256 digest must be 32 bytes")

    @classmethod
    def from_buf(cls, data: bytes) -> "Sha256Hash":
        return cls(hashlib.sha256(data).digest())

    @classmethod
    def from_reader(cls, reader, chunk: int = 1 << 20) -> "Sha256Hash":
        h = hashlib.sha256()
        while True:
            data = reader.read(chunk)
            if not data:
                break
            h.update(data)
        return cls(h.digest())

    @classmethod
    def from_hex(cls, s: str) -> "Sha256Hash":
        try:
            raw = bytes.fromhex(s)
        except ValueError as err:
            raise SerdeError(f"invalid sha256 hex: {s!r}") from err
        return cls(raw)

    def hex(self) -> str:
        return self.digest.hex()

    def verify(self, data: bytes) -> bool:
        return hashlib.sha256(data).digest() == self.digest

    def __str__(self) -> str:
        return self.hex()


@dataclass(frozen=True, order=True)
class AnyHash:
    """Algorithm-tagged hash; the extension point for future algorithms.

    String form ``sha256-<hex>``; serde form ``{"sha256": "<hex>"}`` flattened
    into the chunk mapping (reference: src/file/chunk.rs:14-18).
    """

    algorithm: str
    value: Sha256Hash

    @classmethod
    def sha256(cls, h: Sha256Hash) -> "AnyHash":
        return cls("sha256", h)

    @classmethod
    def from_buf(cls, data: bytes) -> "AnyHash":
        return cls.sha256(Sha256Hash.from_buf(data))

    @classmethod
    def parse(cls, s: str) -> "AnyHash":
        algo, sep, hexpart = s.partition("-")
        if not sep:
            raise SerdeError(f"invalid hash format: {s!r}")
        if algo != "sha256":
            raise SerdeError(f"unknown hash format: {algo!r}")
        return cls.sha256(Sha256Hash.from_hex(hexpart))

    def rehash(self, data: bytes) -> "AnyHash":
        """Hash ``data`` with this hash's algorithm (hash/any.rs:61-67)."""
        return AnyHash.from_buf(data)

    def verify(self, data: bytes) -> bool:
        return self.value.verify(data)

    async def verify_async(self, data: bytes) -> bool:
        return await asyncio.to_thread(self.verify, data)

    async def rehash_async(self, data: bytes) -> "AnyHash":
        return await asyncio.to_thread(self.rehash, data)

    def __str__(self) -> str:
        return f"{self.algorithm}-{self.value.hex()}"


async def hash_buf_async(data: bytes) -> AnyHash:
    return await asyncio.to_thread(AnyHash.from_buf, data)
