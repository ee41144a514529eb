"""Logical devices: the grid the mesh functions shard over.

The port's counterpart of ``chunky_bits_tpu/utils/virtualmesh.py``.  The JAX
package validates its multi-chip layouts on a host that has fewer chips by
asking XLA for ``n`` virtual CPU devices; here a logical device is a torch
device plus a CUDA stream of its own, so ``n`` of them can share one card
(each launches on its own stream and the card runs them side by side), and
the same code runs unchanged with one logical device per real GPU.

* ``virtual_devices(n, base)`` gives ``n`` logical devices on ``base``:
  ``cuda:0`` on the card (one new stream each), ``cpu`` when the caller
  asks for it, as the tests do (no stream: the work runs in order).
* ``visible_devices()`` is what the mesh backends use by default:
  ``$CHUNKY_BITS_TORCH_VIRTUAL_DEVICES`` = n carves n logical devices out of
  ``cuda:0``; unset, every CUDA device is one logical device.  Without a
  card it raises ``ErasureError``: there is no CPU stand-in.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, ContextManager, Optional

import torch

from chunky_bits_tpu_torch.errors import ErasureError

__all__ = ["LogicalDevice", "virtual_devices", "visible_devices"]


@dataclass(frozen=True, eq=False)
class LogicalDevice:
    """One device of a mesh: where its tensors live and the stream its
    work is issued on (None for a CPU device)."""

    index: int
    device: torch.device
    stream: Optional[Any] = None

    def context(self) -> ContextManager:
        """Makes this device and its stream current (nothing on the CPU):
        ``torch.cuda.stream`` switches the current device to the
        stream's for the block."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def __repr__(self) -> str:
        return f"LogicalDevice({self.index}, {self.device})"


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise ErasureError(
            "CUDA is not available: the mesh backends run only on the card "
            "(the CPU runs them only over virtual_devices(n, 'cpu'))")


def virtual_devices(n: int, base: Any = "cuda:0") -> list[LogicalDevice]:
    """``n`` logical devices on the one device ``base``, each with its own
    stream on a CUDA device."""
    if n < 1:
        raise ErasureError(f"want at least one logical device, got {n}")
    dev = torch.device(base)
    if dev.type == "cpu":
        return [LogicalDevice(i, dev) for i in range(n)]
    if dev.type != "cuda":
        raise ErasureError(f"logical devices live on cpu or cuda, not {dev}")
    _require_cuda()
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [LogicalDevice(i, dev, torch.cuda.Stream(dev)) for i in range(n)]


def visible_devices() -> list[LogicalDevice]:
    """The logical devices a mesh backend spans: ``n`` on ``cuda:0`` when
    ``$CHUNKY_BITS_TORCH_VIRTUAL_DEVICES`` = n, else one per CUDA device.
    Raises ``ErasureError`` without a card."""
    from chunky_bits_tpu_torch.cluster.tunables import virtual_devices as env_n

    _require_cuda()
    n = env_n()
    if n:
        return virtual_devices(n, "cuda:0")
    return [LogicalDevice(i, torch.device("cuda", i),
                          torch.cuda.Stream(torch.device("cuda", i)))
            for i in range(torch.cuda.device_count())]
