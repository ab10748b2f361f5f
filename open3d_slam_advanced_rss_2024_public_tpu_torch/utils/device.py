"""Host <-> device transfers that never make the host wait on the stream.

torch synchronises the stream for a blocking copy between host and device,
and a pageable host buffer makes even a ``non_blocking`` copy blocking.
The Mapper's design depends on the host never waiting on the device
(the JAX package's ``copy_to_host_async``), so every transfer on its path
goes through pinned memory with ``non_blocking=True``, and readbacks are
resolved through a CUDA event recorded after the copy.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """``device`` or ``cuda``; raises where CUDA is asked for and absent
    (the port never carries on on the CPU unless the caller asks)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def to_device(x, device, dtype=torch.float32) -> Tensor:
    """Host array or tensor -> tensor on ``device``.  A host tensor goes to
    a CUDA device through one pinned copy, without a stream
    synchronisation."""
    to_cuda = torch.device(device).type == "cuda"
    if isinstance(x, Tensor):
        t = x.to(dtype=dtype)
    else:
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        if not to_cuda:
            return t.clone()
    if to_cuda and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device)


class HostCopy:
    """Device tensors copied to pinned host memory without waiting; an
    event recorded after the copies tells when they have landed."""

    def __init__(self, tensors: Sequence[Tensor]):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.detach().clone() for t in tensors]

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> List[np.ndarray]:
        """Block this thread until the copies have landed; numpy views."""
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]
