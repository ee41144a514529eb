"""Explicit-mesh erasure backend, selectable by name.

The port of ``chunky_bits_tpu/parallel/backend.py``: the multi-device
compute plane (``parallel/mesh.py``) behind the ordinary backend names, so a
caller can pin one mesh for the process the way it selects ``cuda``:

    get_coder(20, 6, "cuda:tp4")        # wide stripes: contraction over 4
    get_coder(10, 4, "cuda:dp4,sp2")    # parts over 4, shard bytes over 2

Axes: ``dp`` splits the part batch, ``sp`` the shard bytes, ``tp`` the
stripe (contraction) with an int16 reduction of K2's partials.  ``tp`` and
``sp`` exclude each other; unspecified axes default so that the product
covers every logical device (``utils/virtualmesh.visible_devices``).  The
name is ``cuda:dp{n},{tp|sp}{m}`` from the resolved axes, so spellings of
one mesh share one registry entry.

Unlike the JAX class, which sends the whole batch in one call, this one
walks the batch in blocks of whole ``dp`` groups under the window's device
memory budget (``ShardedBackend.plan``, which counts K2's int16
accumulators: a config-5 part takes ~1.6 GiB of them).  Part and byte
counts that do not divide by their axis split as evenly as they can, with
no padding.  There is no degrade and no CPU fallback: a failed launch
raises ``ErasureError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops.mesh_backend import Layout, ShardedBackend
from chunky_bits_tpu_torch.utils.virtualmesh import LogicalDevice


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse ``"dp4,sp2"`` -> {"dp": 4, "sp": 2}.  Axes: dp, sp, tp."""
    axes: dict[str, int] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, num = item.partition("=") if "=" in item else (
            item[:2], "", item[2:])
        if name not in ("dp", "sp", "tp") or not num.isdigit() \
                or int(num) < 1:
            raise ErasureError(f"bad mesh axis {item!r} in {spec!r} "
                               f"(want e.g. cuda:dp4,sp2 or cuda:tp4)")
        if name in axes:
            raise ErasureError(f"duplicate mesh axis {name!r} in {spec!r}")
        axes[name] = int(num)
    if "tp" in axes and "sp" in axes:
        raise ErasureError("mesh axes tp and sp are mutually exclusive "
                           "(wide stripes shard bytes via dp instead)")
    if not axes:
        raise ErasureError(f"empty mesh spec {spec!r}")
    return axes


class MeshCudaBackend(ShardedBackend):
    """GF(2^8) matrix application sharded over one explicit mesh of
    logical devices."""

    def __init__(self, spec: str, depth: Optional[int] = None,
                 devices: Optional[Sequence[LogicalDevice]] = None) -> None:
        from chunky_bits_tpu_torch.parallel import mesh as mesh_mod

        axes = parse_mesh_spec(spec)
        if devices is None:
            from chunky_bits_tpu_torch.utils.virtualmesh import visible_devices

            devices = visible_devices()
        n = len(devices)
        self._wide = "tp" in axes
        if self._wide:
            tp = axes["tp"]
            dp = axes.get("dp", max(n // tp, 1))
            mesh = mesh_mod.make_stripe_mesh(dp * tp, dp=dp, tp=tp,
                                             devices=devices)
            minor_name = "tp"
        else:
            dp, sp = axes.get("dp"), axes.get("sp")
            n_dev = dp * sp if (dp and sp) else None
            mesh = mesh_mod.make_mesh(n_dev, dp=dp, sp=sp, devices=devices)
            minor_name = "sp"
        self.dp = mesh.shape["dp"]
        self.minor = mesh.shape[minor_name]
        self.mesh = mesh
        self.name = f"cuda:dp{self.dp},{minor_name}{self.minor}"
        super().__init__(depth=depth, devices=list(mesh.devices.flat))
        self._meshes[(self._wide, self.dp, self.minor)] = mesh

    def _layout(self, b: int, k: int, s: int) -> Layout:
        return Layout(self._wide, self.dp, self.minor, 0)
