"""Host-designed numpy constants moved to a device.

A copy from pageable host memory to a CUDA device waits for the stream to
drain, so a round-trip that uploaded its small constants (window, epilogue
parameters) on every call would serialize host and card. `const_on` uploads
each distinct small array once per device and reuses the tensor.

The program's caches of design constants are `design_cache`s: each is a
`functools.lru_cache` whose misses `const_builds()` counts, the constants
built (and, for a device's, uploaded) since import.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

_builds = 0  # calls into a design_cache's function: its misses
_builds_lock = threading.Lock()


def design_cache(maxsize):
    """`functools.lru_cache(maxsize=maxsize)` whose misses `const_builds()`
    counts."""
    def wrap(fn):
        @functools.wraps(fn)
        def build(*args, **kwargs):
            global _builds
            with _builds_lock:
                _builds += 1
            return fn(*args, **kwargs)
        return functools.lru_cache(maxsize=maxsize)(build)
    return wrap


def const_builds() -> int:
    """The misses of every `design_cache` since import: a call that builds
    no constant leaves it as it was. (Counted in the function a cache
    calls on a miss, so that reading it is one load, where summing every
    cache's `cache_info().misses` takes tens of microseconds.)"""
    return _builds


def as_f32(a, device: torch.device) -> torch.Tensor:
    """A float32 tensor on `device` from a tensor or a (possibly read-only,
    cached) numpy array; host arrays are copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


@design_cache(64)
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
