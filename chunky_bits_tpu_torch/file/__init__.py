"""File codec and I/O substrate (the reference's src/file/ layer): the
object writer and reader, file references, parts, chunks, the read
cache, locations and destinations."""

from chunky_bits_tpu_torch.file.chunk import BlockDigests, Chunk  # noqa: F401
from chunky_bits_tpu_torch.file.chunk_cache import (  # noqa: F401
    CacheStats,
    ChunkCache,
)
from chunky_bits_tpu_torch.file.collection_destination import (  # noqa: F401
    CollectionDestination,
    LocationsDestination,
    ShardWriter,
    VoidDestination,
    WeightedLocationsDestination,
)
from chunky_bits_tpu_torch.file.file_part import (  # noqa: F401
    FileIntegrity,
    FilePart,
    LocationIntegrity,
    ResilverPartReport,
    VerifyPartReport,
    split_into_shards,
)
from chunky_bits_tpu_torch.file.file_reference import (  # noqa: F401
    FileReference,
    ResilverFileReport,
    VerifyFileReport,
)
from chunky_bits_tpu_torch.file.hashing import (  # noqa: F401
    AnyHash,
    Sha256Hash,
)
from chunky_bits_tpu_torch.file.location import (  # noqa: F401
    IGNORE,
    OVERWRITE,
    Location,
    LocationContext,
    Range,
    default_context,
)
from chunky_bits_tpu_torch.file.profiler import (  # noqa: F401
    ProfileReport,
    ProfileReporter,
    Profiler,
    new_profiler,
)
from chunky_bits_tpu_torch.file.reader import FileReadBuilder  # noqa: F401
from chunky_bits_tpu_torch.file.weighted_location import (  # noqa: F401
    WeightedLocation,
)
from chunky_bits_tpu_torch.file.writer import FileWriteBuilder  # noqa: F401
