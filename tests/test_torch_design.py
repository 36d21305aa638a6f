"""The port's host-side design code is byte-identical to the reference's.

The port copies (never imports) the float64 design code of `crlot_tpu`:
windows, COLA norms, folded DFT constants, the composed round-trip basis and
the block-Toeplitz kernels. Equal bytes mean both packages run the same
constants, so every numerical difference between them comes from the
runtime products alone.
"""

import numpy as np
import pytest

import crlot_tpu.fft.matmul_backend as jmm
import crlot_tpu.core.types as jtypes
from crlot_tpu.ola.norm import edge_norm as j_edge_norm
from crlot_tpu.window.windows import get_window as j_get_window

import crlot_tpu_torch.core.types as ttypes
import crlot_tpu_torch.fft.matmul_backend as tmm
from crlot_tpu_torch.convert import config_from_reference
from crlot_tpu_torch.ola.norm import edge_norm as t_edge_norm
from crlot_tpu_torch.window.windows import get_window as t_get_window

CONFIGS = [(1024, 256), (512, 128), (256, 64)]


def _bytes(a, dtype):
    return np.ascontiguousarray(a, dtype).tobytes()


@pytest.mark.parametrize("wtype", list(ttypes.WindowType))
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_windows_identical(wtype, periodic, dtype):
    got = t_get_window(wtype, 1024, periodic, dtype=dtype)
    want = j_get_window(jtypes.WindowType(wtype.value), 1024, periodic,
                        dtype=dtype)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("norm", list(ttypes.NormalizationType))
def test_window_normalizations_identical(norm):
    got = t_get_window(ttypes.WindowType.HANN, 512, True, norm=norm, hop=128)
    want = j_get_window(jtypes.WindowType.HANN, 512, True,
                        norm=jtypes.NormalizationType(norm.value), hop=128)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nfft,hop", CONFIGS)
def test_edge_norm_identical(nfft, hop):
    w = j_get_window(jtypes.WindowType.HANN, nfft, True).astype(np.float64)
    for contrib in (w, w * w):
        f = 23
        full = (f - 1) * hop + nfft
        assert np.array_equal(
            t_edge_norm(contrib, hop, f, full), j_edge_norm(contrib, hop, f, full)
        )


@pytest.mark.parametrize("nfft,hop", CONFIGS)
def test_folded_consts_identical(nfft, hop):
    for t, j in zip(tmm._folded_forward_consts(nfft) + tmm._folded_inverse_consts(nfft),
                    jmm._folded_forward_consts(nfft) + jmm._folded_inverse_consts(nfft)):
        assert t.dtype == j.dtype and np.array_equal(t, j)


def _design_args(nfft, synthesis):
    rng = np.random.default_rng(nfft)
    w64 = j_get_window(jtypes.WindowType.HANN, nfft, True, dtype=np.float64)
    k = nfft // 2 + 1
    resp = rng.uniform(0.2, 1.5, k) * np.exp(1j * rng.uniform(-1, 1, k))
    wb = _bytes(w64, np.float64)
    return wb, (wb if synthesis else None), _bytes(resp, np.complex128)


@pytest.mark.parametrize("nfft,hop", CONFIGS)
@pytest.mark.parametrize("synthesis", [False, True])
def test_composed_basis_and_block_kernels_identical(nfft, hop, synthesis,
                                                    monkeypatch):
    monkeypatch.delenv("CRLOT_BLOCKED_GROUP", raising=False)
    wb, sb, rb = _design_args(nfft, synthesis)
    assert np.array_equal(
        tmm._composed_roundtrip_basis(nfft, wb, sb, rb),
        jmm._composed_roundtrip_basis(nfft, wb, sb, rb),
    )
    group = tmm.blocked_group_for(nfft, hop)
    assert group == jmm.blocked_group_for(nfft, hop)
    assert np.array_equal(
        tmm._composed_block_kernel_grouped(nfft, hop, group, wb, sb, rb),
        jmm._composed_block_kernel_grouped(nfft, hop, group, wb, sb, rb),
    )
    tk, tmg = tmm.blocked_runtime_kernel(nfft, hop, group, wb, sb, rb)
    jk, jmg = jmm.blocked_runtime_kernel(nfft, hop, group, wb, sb, rb)
    assert tmg == jmg and np.array_equal(tk, jk)
    assert tmm.blocked_patch_span(nfft, hop) == jmm.blocked_patch_span(nfft, hop)


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048, 4096, 8192])
def test_blocked_group_matches_reference(nfft, monkeypatch):
    monkeypatch.delenv("CRLOT_BLOCKED_GROUP", raising=False)
    for hop in (32, 64, 100, 128, 256, 512, nfft // 2, nfft):
        assert tmm.blocked_group_for(nfft, hop) == jmm.blocked_group_for(nfft, hop)
    assert tmm.blocked_group_for(1024, 256) == 2


@pytest.mark.parametrize("ref_kwargs", [
    {},
    dict(window=jtypes.WindowType.HAMMING, periodic=False, center=True,
         synthesis_window=True, pad_mode=jtypes.PadMode.EDGE, eps=1e-6),
    dict(fft_backend=jtypes.FftBackend.XLA,
         fft_precision=jtypes.FftPrecision.HIGHEST, fused_roundtrip=True,
         pad_mode=jtypes.PadMode.CONSTANT),
])
def test_config_from_reference_round_trips_every_field(ref_kwargs):
    ref = jtypes.StftConfig(frame_size=1024, hop_size=256, **ref_kwargs)
    got = config_from_reference(ref)
    for name in ref.__dataclass_fields__:
        a, b = getattr(ref, name), getattr(got, name)
        if hasattr(a, "value"):
            assert type(b).__module__.startswith("crlot_tpu_torch")
            a, b = a.value, b.value
        assert a == b, name
    assert got.frame_spec.num_frames(48000) == ref.frame_spec.num_frames(48000)


def test_int8_tier_refused_with_roadmap_item():
    """The INT8X2 tier, once refused at construction, is accepted and
    carried across from the reference field by field."""
    ref = jtypes.StftConfig(frame_size=1024, hop_size=480,
                            fft_precision=jtypes.FftPrecision.INT8X2)
    got = config_from_reference(ref)
    assert got == ttypes.StftConfig(frame_size=1024, hop_size=480,
                                    fft_precision=ttypes.FftPrecision.INT8X2)
    assert got.fft_precision.value == ref.fft_precision.value == "int8x2"
    assert ttypes.float_tier(got.fft_precision) == ttypes.FftPrecision.HIGH
