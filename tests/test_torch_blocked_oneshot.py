"""The blocked one-shot (`pipeline.blocked_composed_round_trip`) writes
the signal once.

It allocates B0's extended input once and writes the zero halos, the
centre pad's pieces and the signal into it in place (`blocked_input`,
`padding.pad_signal_into`), runs B0's product on it as is
(`hopblock_product`), writes the normalised edge patches into B0's output
and returns a view of that output. Here on the CPU, one intra-op thread:
its output is `torch.equal` to the composition it replaced (the centre
pad, `[..., :full].float()`, `hopblock_apply`'s zero pad and product, the
patches and a `torch.cat`), rebuilt below, at every pad mode, length,
shape, dtype, geometry, window and response the route takes; counted op
by op, its own ops write B0's input once and no join copy.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import crlot_tpu_torch as pt
from crlot_tpu_torch import pipeline, spectral
from crlot_tpu_torch.core.padding import pad_signal, pad_signal_into
from crlot_tpu_torch.core.types import PadMode, StftConfig, WindowType
from crlot_tpu_torch.fft import matmul_backend as mb

SR = 48000
GEOMETRIES = [(1024, 256), (512, 128)]
# Hann at hop N/4 folds its norm into the kernel; Blackman-Harris does not
# (its interior COLA sum is not constant), so the interior divides.
WINDOWS = {"hann": WindowType.HANN, "blackman_harris": WindowType.BLACKMAN_HARRIS}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _config(nfft, hop, mode=PadMode.REFLECT, center=True, window="hann"):
    return StftConfig(frame_size=nfft, hop_size=hop, center=center,
                      pad_mode=mode, window=WINDOWS[window])


def _eq(nfft):
    return spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, nfft)


def _shortest(cfg) -> int:
    """The fewest samples the route takes: exactly 2(R-1) frames."""
    frames = 2 * (cfg.frame_size // cfg.hop_size - 1)
    return ((frames - 1) * cfg.hop_size + cfg.frame_size
            - 2 * cfg.frame_spec.pad_amount)


def _lengths(cfg) -> list:
    """The shortest, one whose frames end short of the padded signal's end
    (77 samples past a hop), and one of a few more hops."""
    t = _shortest(cfg)
    return [t, t + 77, t + 5 * cfg.hop_size + 130]


def _x(shape, dtype, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.9, 0.9, shape)).to(dtype)


def _parent(signal, cfg, response):
    """The composition the route ran before it wrote the signal once: the
    centre pad, its first `full` samples in float32, `hopblock_apply`
    (which pads B0's halo with `F.pad`), the normalised patches, the
    interior over its norm and a cat, then the crop."""
    spec_ = cfg.frame_spec
    full = ((spec_.num_frames(signal.shape[-1]) - 1) * cfg.hop_size
            + cfg.frame_size)
    padded = pad_signal(signal, spec_.pad_amount, spec_.pad_amount,
                        spec_.pad_mode, spec_.pad_value)
    plan = mb.blocked_plan_for(cfg, response)
    kern, bt = plan.operands(signal.device, cfg.fft_precision)
    edge, span_p = plan.edge, plan.patch_span
    x = padded[..., :full].float()
    out = mb.hopblock_apply(x, kern, plan.gh, full, edge, cfg.fft_precision,
                            bt)
    head = plan.edge_patch(x[..., :span_p], "head")
    tail = plan.edge_patch(x[..., full - span_p :], "tail")
    out = torch.cat([head, plan.interior_(out[..., edge : full - edge]),
                     tail], dim=-1)
    pad = spec_.pad_amount
    return out[..., pad : pad + signal.shape[-1]]


CASES = list(itertools.product(list(PadMode), [True, False], GEOMETRIES,
                               list(WINDOWS), ["identity", "eq"]))


@pytest.mark.parametrize("mode,center,geometry,window,fn", CASES)
def test_one_shot_equals_the_parent_composition(mode, center, geometry,
                                                window, fn):
    """Every length, shape and dtype of the case: the same bits and the
    same shape as the composition with its three signal-sized copies."""
    nfft, hop = geometry
    cfg = _config(nfft, hop, mode, center, window)
    spectral_fn = _eq(nfft) if fn == "eq" else None
    response = mb.blocked_response(cfg, spectral_fn)
    shortest = _shortest(cfg)
    assert pipeline.formulation_for(cfg, spectral_fn, shortest) == "blocked"
    assert pipeline.formulation_for(cfg, spectral_fn,
                                    shortest - 1) != "blocked"
    seed = 0
    for n, lead, dtype in itertools.product(
            _lengths(cfg), [(), (3,), (2, 2)], [torch.float64, torch.float32]):
        x = _x(lead + (n,), dtype, seed)
        seed += 1
        got = pt.round_trip(x, cfg, spectral_fn)
        want = _parent(x, cfg, response)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want), (n, lead, dtype)


def test_some_lengths_end_short_of_the_padded_signal():
    """The cases above include lengths whose last frame ends before the
    padded signal does, centred and not, so the writer cuts the right
    piece (or the signal) at `full`."""
    for center, (nfft, hop) in itertools.product([True, False], GEOMETRIES):
        cfg = _config(nfft, hop, center=center)
        spec_ = cfg.frame_spec
        n = _lengths(cfg)[1]
        full = (spec_.num_frames(n) - 1) * hop + nfft
        assert full < n + 2 * spec_.pad_amount


@pytest.mark.parametrize("mode,center", list(itertools.product(
    list(PadMode), [True, False])))
@pytest.mark.parametrize("nfft,hop", GEOMETRIES)
def test_blocked_input_is_the_padded_signal_in_b0s_halo(mode, center, nfft,
                                                        hop):
    """`blocked_input` is byte-equal to `F.pad(pad_signal(...)[...,
    :full].float(), (edge, right))`, the input `hopblock_apply` built, at
    each length and dtype; the signal starts at a multiple of 4."""
    cfg = _config(nfft, hop, mode, center)
    spec_ = cfg.frame_spec
    plan = mb.blocked_plan_for(cfg, mb.blocked_response(cfg, None))
    kern = torch.from_numpy(plan.kernel())
    for n, dtype in itertools.product(_lengths(cfg),
                                      [torch.float64, torch.float32]):
        x = _x((2, n), dtype, n)
        full = (spec_.num_frames(n) - 1) * hop + nfft
        got, edge = pipeline.blocked_input(x, cfg, full)
        padded = pad_signal(x, spec_.pad_amount, spec_.pad_amount,
                            spec_.pad_mode, spec_.pad_value)
        want, _, _ = mb._hopblock_ext(padded[..., :full].float(), kern,
                                      plan.gh, full, plan.edge)
        assert edge == plan.edge and got.dtype == torch.float32
        assert torch.equal(got, want), (n, dtype)
    assert (plan.edge + spec_.pad_amount) % 4 == 0


@pytest.mark.parametrize("mode,value,dtype,pads,n,length", [
    (PadMode.REFLECT, 0.0, torch.float32, (5, 7), 20, 32),
    (PadMode.REFLECT, 0.0, torch.float64, (5, 7), 20, 29),
    (PadMode.REFLECT, 0.0, torch.float32, (5, 7), 20, 21),
    (PadMode.REFLECT, 0.0, torch.float32, (5, 7), 20, 3),
    (PadMode.REFLECT, 0.0, torch.float32, (30, 45), 20, 95),  # gathers
    (PadMode.REFLECT, 0.0, torch.float32, (0, 0), 20, 20),
    (PadMode.EDGE, 0.0, torch.float32, (6, 4), 10, 20),
    (PadMode.EDGE, 0.0, torch.float64, (6, 4), 10, 17),
    (PadMode.CONSTANT, 0.3, torch.float64, (6, 4), 10, 20),
    (PadMode.CONSTANT, 0.3, torch.float16, (6, 4), 10, 18),
    (PadMode.CONSTANT, 0.5, torch.int32, (6, 4), 10, 20),
])
def test_pad_signal_into_writes_the_padded_signal(mode, value, dtype, pads,
                                                  n, length):
    """`pad_signal_into` writes `pad_signal`'s first `length` samples
    converted to float32, the conversion `.float()` makes (a constant
    taken in the signal's dtype first), and nothing outside `dst`."""
    x = (torch.arange(2 * n, dtype=torch.float64).reshape(2, n) * 1.37
         - 9.1).to(dtype)
    buf = torch.full((2, length + 4), -7.0)
    pad_signal_into(buf[:, 2 : 2 + length], x, *pads, mode, value)
    want = pad_signal(x, *pads, mode, value)[..., :length].float()
    assert torch.equal(buf[:, 2 : 2 + length], want)
    assert bool((buf[:, :2] == -7.0).all() and (buf[:, -2:] == -7.0).all())


def test_pad_signal_into_refuses_more_than_the_padded_signal():
    with pytest.raises(ValueError, match="exceed"):
        pad_signal_into(torch.empty(2, 40), torch.zeros(2, 20), 5, 7,
                        PadMode.REFLECT)


# --- what the route writes --------------------------------------------------


class _Writes(TorchDispatchMode):
    """The bytes every op writes into tensors whose shape starts with the
    signal's leading dims (rows): the destinations of in-place ops, and
    the outputs of the others that are not views of their inputs (an
    allocation writes nothing). Ops run while `_Writes.paused` are left
    out. `copies` lists each in-place copy's (dtype, elements)."""

    paused = 0

    def __init__(self, lead) -> None:
        super().__init__()
        self.lead, self.bytes, self.copies = tuple(lead), 0, []

    def _rows(self, t) -> bool:
        return (isinstance(t, torch.Tensor) and t.dim() > len(self.lead)
                and tuple(t.shape[: len(self.lead)]) == self.lead)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _Writes.paused:
            return out
        written = [a for a, arg in zip(args, func._schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write]
        if written:
            if func is torch.ops.aten.copy_.default:
                self.copies.append((args[0].dtype, args[0].numel()))
        elif func.overloadpacket in (torch.ops.aten.empty,
                                     torch.ops.aten.empty_strided):
            written = []
        else:
            inputs = {t.untyped_storage().data_ptr()
                      for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor)}
            written = [t for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)
                       and t.untyped_storage().data_ptr() not in inputs]
        self.bytes += sum(t.numel() * t.element_size() for t in written
                          if self._rows(t))
        return out


@pytest.fixture
def b0_outputs(monkeypatch):
    """B0's products and the edge patches left out of every `_Writes`
    (in the route and in `hopblock_apply`); the list of B0's outputs."""
    outputs = []

    def paused(fn, keep=None):
        def call(*args, **kwargs):
            _Writes.paused += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _Writes.paused -= 1
            if keep is not None:
                keep.append(out)
            return out
        return call

    product = mb.hopblock_product
    monkeypatch.setattr(pipeline, "hopblock_product",
                        paused(product, outputs))
    monkeypatch.setattr(mb, "hopblock_product", paused(product))
    monkeypatch.setattr(mb.BlockedPlan, "edge_patch",
                        paused(mb.BlockedPlan.edge_patch))
    return outputs


COUNT_CASES = [
    # mode, center, window, dtype, lead
    (PadMode.REFLECT, True, "hann", torch.float32, (4,)),
    (PadMode.REFLECT, True, "hann", torch.float32, ()),
    (PadMode.REFLECT, True, "hann", torch.float64, (2, 3)),
    (PadMode.REFLECT, True, "blackman_harris", torch.float32, (4,)),
    (PadMode.EDGE, True, "hann", torch.float32, (4,)),
    (PadMode.CONSTANT, True, "blackman_harris", torch.float64, (4,)),
    (PadMode.REFLECT, False, "hann", torch.float32, (4,)),
]


@pytest.mark.parametrize("mode,center,window,dtype,lead", COUNT_CASES)
@pytest.mark.parametrize("extra", [0, 77])
def test_the_route_writes_b0s_input_once(b0_outputs, mode, center, window,
                                         dtype, lead, extra):
    """The bytes the route's own ops write, counted op by op with B0's
    product and the edge patches left out: at most B0's extended input
    once, the edge patches written into B0's output, the centre pad's
    pieces before they are copied in (in the signal's dtype), and where
    the norm does not fold the interior's in-place divide; fewer than the
    parent composition by the join's cat less the patches it held and,
    centred, one more float32 signal (the pad's and `F.pad`'s copies
    against the one buffer); and the output is a view of B0's product."""
    cfg = _config(1024, 256, mode, center, window)
    fn = _eq(1024)
    response = mb.blocked_response(cfg, fn)
    plan = mb.blocked_plan_for(cfg, response)
    spec_ = cfg.frame_spec
    n = _shortest(cfg) + 3 * 256 + extra
    full = (spec_.num_frames(n) - 1) * 256 + 1024
    _, length = mb.hopblock_extent(full, plan.gh, plan.mg)
    x = _x(lead + (n,), dtype)
    pt.round_trip(x, cfg, fn)  # the plan and its constants, built once
    count = _Writes(lead)
    with count:
        y = pt.round_trip(x, cfg, fn)
    rows = int(np.prod(lead))
    per_row = (4 * (length + 2 * plan.edge)
               + x.element_size() * 2 * spec_.pad_amount
               + (4 * full if plan.tile is not None else 0))
    assert 4 * rows * length <= count.bytes <= rows * per_row
    assert (y.untyped_storage().data_ptr()
            == b0_outputs[-1].untyped_storage().data_ptr())
    parent = _Writes(lead)
    with parent:
        _parent(x, cfg, response)
    signals = 2 if spec_.pad_amount else 1  # no centre pad: no pad copy
    assert (parent.bytes - count.bytes
            >= 4 * rows * (signals * full - 2 * plan.edge))


@pytest.mark.parametrize("nfft,hop", GEOMETRIES)
def test_the_route_writes_one_signal_sized_buffer(b0_outputs, nfft, hop):
    """At a folding window on a float32 signal the route writes B0's
    extended input once plus halo-sized pieces: at most rows x (L + 2 edge
    + 2 pad) floats, where the parent composition wrote three
    signal-sized tensors (the pad's cat, `F.pad`'s, the join's cat). The
    signal is written by one copy, and the output is a view of B0's
    product: no join copy."""
    cfg = _config(nfft, hop)
    fn = _eq(nfft)
    lead = (4,)
    n = 48000
    x = _x(lead + (n,), torch.float32)
    pt.round_trip(x, cfg, fn)
    count = _Writes(lead)
    with count:
        y = pt.round_trip(x, cfg, fn)
    spec_ = cfg.frame_spec
    full = (spec_.num_frames(n) - 1) * hop + nfft
    plan = mb.blocked_plan_for(cfg, mb.blocked_response(cfg, fn))
    _, length = mb.hopblock_extent(full, plan.gh, plan.mg)
    bound = 4 * 4 * (length + 2 * plan.edge + 2 * spec_.pad_amount)
    assert count.bytes <= bound
    assert (torch.float32, 4 * n) in count.copies
    assert (y.untyped_storage().data_ptr()
            == b0_outputs[-1].untyped_storage().data_ptr())

    parent = _Writes(lead)
    with parent:
        _parent(x, cfg, mb.blocked_response(cfg, fn))
    assert parent.bytes > 2.5 * count.bytes
