"""Multi-host bootstrap for the distributed compute plane (the port of
``chunky_bits_tpu/parallel/multihost.py``).

Reed-Solomon parts are independent stripes, so the part-batch axis ('dp')
is embarrassingly parallel and the compute plane needs no collective
between hosts.  The layout that follows, as in the JAX package:

* **Between hosts** travel only the object plane (HTTP shard reads and
  writes, metadata) and the one-time control handshake of the process
  group.  No shard byte crosses the group.
* **Within a host** run the only collectives the math has, the 'tp'
  reduce-and-pack and the 'sp' byte split (parallel/mesh.py), over this
  process's logical devices: each process encodes its own slice of parts
  on its own card(s).

``init_multihost`` joins the processes into one ``torch.distributed``
process group (so the job's topology is queryable, and the ranks can
agree on a barrier or exchange small control objects), and
``partition_parts`` deals the part batch across them.

The group's backend is an argument, ``gloo`` by default: the group
carries control messages on the host, never tensors of the card, and
NCCL refuses two ranks on one GPU, which is how a one-card box runs a
multi-process job.
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional, Sequence

import torch.distributed as dist

from chunky_bits_tpu_torch.utils.virtualmesh import LogicalDevice

log = logging.getLogger("chunky_bits_tpu_torch.multihost")

__all__ = ["init_multihost", "local_mesh", "local_stripe_mesh",
           "partition_parts"]

#: bound on the rendezvous and on every later collective of the group: a
#: peer that never arrives fails the job instead of hanging it
DEFAULT_TIMEOUT_S = 120.0

_INITIALIZED = False


def _process() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   auto: bool = False, *, backend: str = "gloo",
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join (or detect) the multi-host process group; idempotent.

    Three ways in, checked in order:

    1. explicit arguments (``coordinator_address`` as ``host:port``, with
       ``num_processes`` and ``process_id``): a ``tcp://`` rendezvous;
       failures propagate, and explicit arguments after this process was
       finalized single-process raise instead of being ignored;
    2. ``$CHUNKY_BITS_TORCH_COORDINATOR_ADDRESS``, with
       ``$CHUNKY_BITS_TORCH_NUM_PROCESSES`` and
       ``$CHUNKY_BITS_TORCH_PROCESS_ID``;
    3. ``auto=True``: an ``env://`` rendezvous from the variables
       ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
       ``RANK``), which torch reads itself.

    With none of these it is a single-process no-op, so the same code runs
    unchanged on one host.  ``backend`` names the group's backend (see the
    module docstring for why ``gloo``); ``timeout_s`` bounds the
    rendezvous.  Returns ``(process_index, process_count)``."""
    global _INITIALIZED
    from chunky_bits_tpu_torch.cluster import tunables

    explicit = (coordinator_address is not None
                or num_processes is not None
                or process_id is not None)
    if dist.is_available() and dist.is_initialized():
        _INITIALIZED = True
        return _process()
    if _INITIALIZED:
        if explicit:
            raise RuntimeError(
                "init_multihost() already finalized this process as "
                "single-host; pass coordinator args on the first call")
        return _process()

    timeout = datetime.timedelta(seconds=timeout_s)
    init_method = None
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "init_multihost: coordinator_address, num_processes and "
                "process_id go together")
        job = (coordinator_address, num_processes, process_id)
    else:
        job = tunables.coordinator()
    if job is not None:
        init_method = f"tcp://{job[0]}"
        kwargs = {"world_size": job[1], "rank": job[2]}
    elif auto:
        init_method, kwargs = "env://", {}
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                timeout=timeout, **kwargs)
        log.info("joined %s as process %d of %d (backend %s)",
                 init_method, dist.get_rank(), dist.get_world_size(),
                 dist.get_backend())
    _INITIALIZED = True
    return _process()


def local_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
               devices: Optional[Sequence[LogicalDevice]] = None):
    """('dp', 'sp') mesh over this process's logical devices (default
    ``visible_devices()``, so ``$CHUNKY_BITS_TORCH_VIRTUAL_DEVICES``
    applies; the CPU tests pass ``virtual_devices(n, "cpu")``).  The
    cross-host axis is the object plane, not the mesh: each process gets
    its own mesh and its own slice of parts (``partition_parts``)."""
    from chunky_bits_tpu_torch.parallel.mesh import make_mesh
    from chunky_bits_tpu_torch.utils.virtualmesh import visible_devices

    local = list(devices) if devices is not None else visible_devices()
    return make_mesh(len(local), dp=dp, sp=sp, devices=local)


def local_stripe_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                      devices: Optional[Sequence[LogicalDevice]] = None):
    """('dp', 'tp') wide-stripe mesh over this process's logical devices;
    the 'tp' reduce-and-pack stays inside the process."""
    from chunky_bits_tpu_torch.parallel.mesh import make_stripe_mesh
    from chunky_bits_tpu_torch.utils.virtualmesh import visible_devices

    local = list(devices) if devices is not None else visible_devices()
    return make_stripe_mesh(len(local), dp=dp, tp=tp, devices=local)


def partition_parts(total_parts: int,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> tuple[int, int]:
    """Deal a global part batch across processes: the ``[start, stop)``
    slice this process encodes.  Contiguous balanced slices (the first
    ``total % n`` processes take one extra part), so the ordered
    assembly of the writer concatenates the processes' results without
    reshuffling.  Unset index and count come from the process group
    (0 and 1 outside one)."""
    rank, world = _process()
    n = process_count if process_count is not None else world
    i = process_index if process_index is not None else rank
    if not 0 <= i < n:
        raise ValueError(f"process_index {i} outside 0..{n - 1}")
    base, extra = divmod(total_parts, n)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return start, stop
