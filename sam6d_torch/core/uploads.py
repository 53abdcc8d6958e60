"""Host -> device copies that do not wait for the card.

`torch.as_tensor(array, device="cuda")` copies from pageable memory, and
PyTorch follows such a copy with a stream synchronize: the host waits for
every kernel queued before it. The frame chain uploads through pinned
memory instead (`upload`): the copy is queued with `non_blocking=True`, and
PyTorch's caching host allocator records the copy's event, so the pinned
block is not reused before the copy has run. Values that depend only on
the configuration or the frame geometry are uploaded once and kept
(`device_constant`). On the CPU both return what `torch.as_tensor` would.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable

import numpy as np
import torch
from torch._guards import detect_fake_mode

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def upload(x, device, dtype: torch.dtype = None) -> torch.Tensor:
    """`x` (a numpy array, a number, or a CPU tensor) on `device`, in
    `dtype` if given (converted on the host, as torch.as_tensor does). A CUDA
    device gets a non-blocking copy from pinned memory; a tensor already on
    a device is only moved or cast there."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        t = torch.as_tensor(np.ascontiguousarray(a) if a.ndim else a)
    if t.device.type != "cpu":
        return t.to(device=device, dtype=dtype)
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_constant(key: Hashable, make: Callable[[], object], device,
                    dtype: torch.dtype = None) -> torch.Tensor:
    """The tensor `upload(make(), device, dtype)`, made at the first call
    for (key, device, dtype) and returned by every later one. Callers must
    not write into it. While a graph is traced (torch.export, torch.compile)
    nothing is kept: the traced program makes its own constant."""
    device = torch.device(device)
    if torch.compiler.is_compiling() or detect_fake_mode() is not None:
        return torch.as_tensor(make(), dtype=dtype, device=device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    k = (key, str(device), dtype)
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = upload(make(), device, dtype)
    return t
