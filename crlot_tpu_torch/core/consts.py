"""Host-designed numpy constants moved to a device.

A copy from pageable host memory to a CUDA device waits for the stream to
drain, so a round-trip that uploaded its small constants (window, epilogue
parameters) on every call would serialize host and card. `const_on` uploads
each distinct small array once per device and reuses the tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def as_f32(a, device: torch.device) -> torch.Tensor:
    """A float32 tensor on `device` from a tensor or a (possibly read-only,
    cached) numpy array; host arrays are copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


@lru_cache(maxsize=64)
def _const_on(data: bytes, dtype: str, shape: tuple,
              device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.tensor(arr, device=device)


def const_on(a, device: torch.device, dtype=np.float32) -> torch.Tensor:
    """The small host array `a` (cast to `dtype`) as a tensor on `device`,
    uploaded once per distinct content and device. Callers must not
    modify the returned tensor."""
    arr = np.ascontiguousarray(a, dtype=dtype)
    return _const_on(arr.tobytes(), arr.dtype.str, arr.shape,
                     torch.device(device))
