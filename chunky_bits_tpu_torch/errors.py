"""Error taxonomy, one class per failure domain (the port's own copy of
``chunky_bits_tpu/errors.py``; the device-timeout classes stay behind,
since the CUDA backend has no degrade path to signal).

Mirrors the reference's per-domain error enums and conversion lattice
(reference: src/error.rs:43-281): LocationError -> ShardError ->
FileWriteError/FileReadError -> ClusterError, plus MetadataReadError,
LocationParseError and SerdeError.  Python exception subclassing replaces the
Rust ``From`` conversions.
"""

from __future__ import annotations


class ChunkyBitsError(Exception):
    """Base class for every error raised by this framework."""


class LocationParseError(ChunkyBitsError, ValueError):
    """A location string could not be parsed (src/error.rs:256-281)."""


class LocationError(ChunkyBitsError):
    """I/O against a single Location failed (src/error.rs:101-136)."""


class WriteToRangeError(LocationError):
    """Attempted to write to a byte-range location (src/error.rs:112)."""

    def __init__(self) -> None:
        super().__init__("cannot write to a ranged location")


class HttpStatusError(LocationError):
    """Non-success HTTP status from a storage node."""

    def __init__(self, status: int, url: str):
        super().__init__(f"http status {status} for {url}")
        self.status = status
        self.url = url


#: HTTP statuses worth one jittered-backoff retry against the same
#: location before falling through (reads) / invalidating the node
#: (writes).  Other 4xx and 507 are deterministic — retrying a full
#: disk or a missing chunk only adds latency.
TRANSIENT_HTTP_STATUSES = frozenset((408, 429, 500, 502, 503, 504))


def is_transient_error(err: BaseException) -> bool:
    """True when ``err`` (a LocationError, or a ShardError wrapping one
    as its ``__cause__``) names a transient HTTP failure worth a single
    retry (``tunables.read_retries``)."""
    for cand in (err, err.__cause__):
        if isinstance(cand, HttpStatusError):
            return cand.status in TRANSIENT_HTTP_STATUSES
    return False


class ShardError(ChunkyBitsError):
    """A single shard write failed; carries the failing location
    (src/error.rs:77-97)."""

    def __init__(self, message: str = "shard write failed", location=None):
        super().__init__(message)
        self.location = location


class NotEnoughWriters(ChunkyBitsError):
    """Destination cannot supply d+p shard writers (src/error.rs:57)."""


class NotEnoughAvailability(ShardError):
    """Placement ran out of candidate nodes (src/cluster/writer.rs:254-276)."""

    def __init__(self) -> None:
        super().__init__("not enough availability to place shard")


class FileWriteError(ChunkyBitsError):
    """Whole-file ingest failed (src/error.rs:43-73)."""


class FileReadError(ChunkyBitsError):
    """Whole-file read failed (src/error.rs:139-164)."""


class NotEnoughChunks(FileReadError):
    """Fewer than ``d`` intact chunks; reconstruction impossible."""


class ErasureError(ChunkyBitsError):
    """Erasure-codec level failure (bad geometry, too many erasures, no
    CUDA device, a kernel that fails to build or launch)."""


class ClusterError(ChunkyBitsError):
    """Cluster-level failure (src/error.rs:167-192)."""


class SerdeError(ChunkyBitsError):
    """(De)serialization failure (src/error.rs:195-217)."""


class MetadataReadError(ChunkyBitsError):
    """Metadata store failure, incl. put_script exit codes
    (src/error.rs:220-253)."""
