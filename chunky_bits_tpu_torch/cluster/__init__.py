"""Cluster orchestration (the reference's src/cluster/ layer): placement,
profiles, metadata stores, the location-health scoreboard and tunables."""

from chunky_bits_tpu_torch.cluster.cluster import Cluster  # noqa: F401
from chunky_bits_tpu_torch.cluster.destination import (  # noqa: F401
    ClusterWriter,
    Destination,
)
from chunky_bits_tpu_torch.cluster.metadata import (  # noqa: F401
    FileOrDirectory,
    MetadataFormat,
    MetadataGit,
    MetadataPath,
    metadata_from_obj,
)
from chunky_bits_tpu_torch.cluster.nodes import (  # noqa: F401
    ClusterNode,
    ClusterNodes,
)
from chunky_bits_tpu_torch.cluster.profile import (  # noqa: F401
    ClusterProfile,
    ClusterProfiles,
    ZoneRule,
)
from chunky_bits_tpu_torch.cluster.tunables import Tunables  # noqa: F401
