"""Host- and device-plane parallelism.

Three parts live here: the mesh-sharded erasure transforms (``mesh`` and
``backend``: several logical devices, on one card or many), the host
compute pipeline (``host_pipeline``: multi-core ingest hashing and
encode) and the multi-host bootstrap (``multihost``: the process group
and each process's slice of parts and local mesh).  The package exports
resolve lazily (PEP 562), so importing the host plane loads none of the
mesh modules.
"""

from typing import Any

_MESH_EXPORTS = (
    "Mesh",
    "encode_step_sharded",
    "encode_wide_sharded",
    "make_mesh",
    "make_stripe_mesh",
    "sharded_apply",
    "wide_apply_sharded",
)
_HOST_PIPELINE_EXPORTS = (
    "HostPipeline",
    "get_host_pipeline",
)
_MULTIHOST_EXPORTS = (
    "init_multihost",
    "local_mesh",
    "local_stripe_mesh",
    "partition_parts",
)

__all__ = list(_MESH_EXPORTS + _HOST_PIPELINE_EXPORTS + _MULTIHOST_EXPORTS)


def __getattr__(name: str) -> Any:
    if name in _MESH_EXPORTS:
        from chunky_bits_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name in _HOST_PIPELINE_EXPORTS:
        from chunky_bits_tpu_torch.parallel import host_pipeline

        return getattr(host_pipeline, name)
    if name in _MULTIHOST_EXPORTS:
        from chunky_bits_tpu_torch.parallel import multihost

        return getattr(multihost, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
