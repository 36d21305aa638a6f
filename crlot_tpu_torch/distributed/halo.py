"""Halo exchange between the time shards of one channel group.

Counterpart of `crlot_tpu/distributed/halo.py`. Each time block needs the
first `N - H` samples of its RIGHT neighbour to frame its trailing hops
(overlap-save), and hands an `N - H`-sample OLA tail to its right
neighbour's head (overlap-add). The reference moves them with one
`ppermute` each way inside `shard_map`; here each function takes the list
of one channel group's shards (in time order) and returns what each shard
receives, moved to that shard's device with `.to(..., non_blocking=True)`.
Edge shards receive zeros: the "no neighbour" semantics of `ppermute`.
Only the halo samples move, so the volume per edge is O(frame), not
O(block).
"""

from __future__ import annotations

import torch


def pull_right_halo(shards: list, halo: int) -> list:
    """Each shard receives the first `halo` samples of its right
    neighbour's block ([..., halo]; zeros on the last shard)."""
    heads = [s[..., :halo] for s in shards]
    out = [heads[d + 1].to(shards[d].device, non_blocking=True)
           for d in range(len(shards) - 1)]
    return out + [torch.zeros_like(heads[-1])]


def push_right_tail(tails: list) -> list:
    """Each shard sends its OLA tail to its right neighbour and receives
    its left neighbour's (zeros on the first shard)."""
    out = [torch.zeros_like(tails[0])]
    return out + [tails[d - 1].to(tails[d].device, non_blocking=True)
                  for d in range(1, len(tails))]


def pull_left_halo(shards: list, halo: int) -> list:
    """Each shard receives the LAST `halo` samples of its left neighbour's
    block (zeros on the first shard): the look-back context of the blocked
    hop-block formulation."""
    return push_right_tail([s[..., s.shape[-1] - halo:] for s in shards])
