"""Halo exchange between the time shards of one channel group.

Counterpart of `crlot_tpu/distributed/halo.py`. Each time block needs the
first `N - H` samples of its RIGHT neighbour to frame its trailing hops
(overlap-save), and hands an `N - H`-sample OLA tail to its right
neighbour's head (overlap-add). The reference moves them with one
`ppermute` each way inside `shard_map`; here each function takes the list
of one channel group's shards (in time order) and returns what each shard
receives. Edge shards receive zeros: the "no neighbour" semantics of
`ppermute`. Only the halo samples move, so the volume per edge is
O(frame), not O(block).

Within a process a halo is a `.to(device, non_blocking=True)`. Given a
`group` (the mesh and the channel row) on a mesh that spans processes, a
shard this rank does not hold is `None` in the list it passes and gets,
and a neighbour in another rank is reached by `torch.distributed`
point-to-point ops: `isend` / `irecv` of the card's tensors under NCCL;
under gloo, whose sends take CPU tensors, a card's outgoing halo is copied
to a pinned host buffer before the send and the received one back to the
card after the receive. Every exchange is issued at once and a received
halo arrives as a `Pending` that the caller waits on only where a product
needs it (`received`).

`counter` counts the exchanges: for each shard, the bytes of each halo it
receives (zeros at the edges too, as every device runs each `ppermute` of
the reference's program), the bytes that really moved, and those that
crossed ranks with the time spent staging and waiting. It is the
counterpart of the collective-permutes of the reference's compiled HLO.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch
import torch.distributed as dist


class ExchangeCounter:
    """Halo traffic since the last `reset()`."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        # (c, t) -> the bytes of each halo it received, the last 64
        self.per_shard = {}
        self.received_bytes = 0  # every halo received, zeros included
        self.moved_bytes = 0  # between shards, zeros excluded
        self.cross_rank_ops = 0
        self.cross_rank_bytes = 0
        self.staging_s = 0.0  # host time copying halos to and from the card
        self.wait_s = 0.0  # host time blocked on a receive

    def add(self, shard, nbytes: int, moved: bool, cross_rank: bool) -> None:
        self.per_shard.setdefault(shard, deque(maxlen=64)).append(nbytes)
        self.received_bytes += nbytes
        if moved:
            self.moved_bytes += nbytes
        if cross_rank:
            self.cross_rank_ops += 1
            self.cross_rank_bytes += nbytes


counter = ExchangeCounter()


def halo_counts() -> dict:
    """The counter's totals whose change a `crlot.sharded.halo` span
    records (`profiling.span`)."""
    return {"moved_bytes": counter.moved_bytes,
            "received_bytes": counter.received_bytes,
            "cross_rank_ops": counter.cross_rank_ops}


class Pending:
    """A halo arriving from another rank: `wait()` returns it on the
    receiving shard's device."""

    def __init__(self, works, buf: torch.Tensor, device: torch.device):
        self._works, self._buf, self._device = works, buf, device
        self._out: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            t0 = time.perf_counter()
            for w in self._works:
                w.wait()
            t1 = time.perf_counter()
            self._out = self._buf.to(self._device, non_blocking=True)
            counter.wait_s += t1 - t0
            counter.staging_s += time.perf_counter() - t1
        return self._out


def received(h) -> torch.Tensor:
    """A received halo as a tensor (waiting if it comes from another
    rank)."""
    return h.wait() if isinstance(h, Pending) else h


def _staged(t: torch.Tensor) -> bool:
    """Whether a send of `t` goes through host memory: gloo with a card's
    tensor."""
    return t.device.type != "cpu" and dist.get_backend() != "nccl"


def _outgoing(t: torch.Tensor) -> torch.Tensor:
    """`t` as the send takes it: contiguous, copied to pinned host memory
    (and synchronized) under gloo."""
    t = t.contiguous()
    if not _staged(t):
        return t
    t0 = time.perf_counter()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    counter.staging_s += time.perf_counter() - t0
    return host


def _shift(items: list, step: int, group, tag: int) -> list:
    """Shard t receives items[t + step] (zeros past either end); `items[t]`
    is None where this rank does not hold shard t, and so is its entry of
    the result."""
    n = len(items)
    like = next(it for it in items if it is not None)
    if group is None:
        mesh, c = None, 0
    else:
        mesh, c = group
    nbytes = like.numel() * like.element_size()
    out = [None] * n
    ops = []  # (send?, tensor, peer rank, receiver t)
    for t in range(n):
        src = t + step
        here = mesh is None or mesh.local(c, t)
        has_src = 0 <= src < n
        src_here = has_src and (mesh is None or mesh.local(c, src))
        if here:
            counter.add((c, t), nbytes, has_src, has_src and not src_here)
            if not has_src:
                out[t] = torch.zeros_like(items[t])
            elif src_here:
                out[t] = items[src].to(items[t].device, non_blocking=True)
            else:
                ops.append((False, None, mesh.owner(c, src), t))
        elif src_here:
            ops.append((True, _outgoing(items[src]), mesh.owner(c, t), t))
    if not ops:
        return out
    staged = _staged(like)
    bufs = {}
    for send, tensor, peer, t in ops:
        if not send:
            bufs[t] = torch.empty(like.shape, dtype=like.dtype,
                                  device="cpu" if staged else like.device,
                                  pin_memory=staged)
    key = lambda t: tag * 1_000_003 + c * 1009 + t  # noqa: E731
    if dist.get_backend() == "nccl":
        # One coalesced group: its works (often a single one) cover every
        # op of the batch.
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend if send else dist.irecv,
                       tensor if send else bufs[t], peer, tag=key(t))
            for send, tensor, peer, t in ops])
    else:
        works = [dist.isend(tensor, peer, tag=key(t)) if send
                 else dist.irecv(bufs[t], peer, tag=key(t))
                 for send, tensor, peer, t in ops]
    # A received halo is complete when the exchange's works are: its
    # receive, and this rank's own sends of the exchange with it.
    for send, _, _, t in ops:
        if not send:
            out[t] = Pending(works, bufs[t], items[t].device)
    if all(op[0] for op in ops):
        for w in works:
            w.wait()
    return out


def pull_right_halo(shards: list, halo: int, group=None) -> list:
    """Each shard receives the first `halo` samples of its right
    neighbour's block ([..., halo]; zeros on the last shard). `group` =
    (mesh, channel row) names the shards' places for the counter and, on a
    mesh that spans processes, their ranks."""
    heads = [None if s is None else s[..., :halo] for s in shards]
    return _shift(heads, 1, group, tag=1)


def push_right_tail(tails: list, group=None) -> list:
    """Each shard sends its OLA tail to its right neighbour and receives
    its left neighbour's (zeros on the first shard)."""
    return _shift(tails, -1, group, tag=2)


def pull_left_halo(shards: list, halo: int, group=None) -> list:
    """Each shard receives the LAST `halo` samples of its left neighbour's
    block (zeros on the first shard): the look-back context of the blocked
    hop-block formulation."""
    ends = [None if s is None else s[..., s.shape[-1] - halo:]
            for s in shards]
    return _shift(ends, -1, group, tag=3)
