"""Where array-like input goes: the card, unless the caller asks otherwise.

The port's entry points take a torch tensor or an array-like (numpy). A
tensor stays on its own device: the caller chose it. An array-like goes to
`device`, which defaults to "cuda"; `device="cpu"` is how a caller (or a
test) asks for the CPU. Without a card the default raises: nothing runs on
the CPU unless it was asked for.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """`device` as a torch.device (default "cuda"); a CUDA device raises
    when no card is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_indexed(device=None) -> torch.device:
    """`resolve(device)` as the tensors made there report it: "cuda" names
    the current card by its index, so it compares equal to a tensor's
    device."""
    return torch.empty(0, device=resolve(device)).device


def place(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor as it is (cast to `dtype` if given; `device` must then be
    None), or an array-like as a new tensor on `resolve(device)`."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            raise ValueError(
                "device= applies to array input; a tensor stays on its own "
                f"device ({x.device})"
            )
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve(device))
