"""OLA + normalize (the B1 kernel's plain version), padding and framing:
port vs reference on the CPU.

B1's contract is bit-exactness with the canonical ascending-frame OLA, the
same gate `tests/test_fused_ola.py` holds the Pallas kernel to; here the
port's plain version must equal both the Pallas kernel (interpret mode) and
the reference's jnp OLA exactly. The norm oracle `brute_force_norm` is
byte-identical to the reference's, and `edge_index` equal to it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu.core.padding import pad_signal as j_pad
from crlot_tpu.core.types import FrameSpec as JFrameSpec, PadMode as JPadMode
from crlot_tpu.core.types import WindowType
from crlot_tpu.frame.framing import frame_signal as j_frame_signal
from crlot_tpu.ola.fused import ola_normalized_fused
from crlot_tpu.ola.norm import edge_norm
from crlot_tpu.ola.reference import overlap_add_normalized as j_ola_norm
from crlot_tpu.window.windows import get_window

from crlot_tpu_torch.core.padding import pad_signal as t_pad
from crlot_tpu_torch.core.types import FrameSpec as TFrameSpec, PadMode as TPadMode
from crlot_tpu_torch.frame.framing import frame_signal as t_frame_signal
from crlot_tpu_torch.ola import fused as t_fused
from crlot_tpu_torch.ola.reference import overlap_add as t_overlap_add


def _case(n, hop, f, batch, seed):
    rng = np.random.default_rng(seed)
    shape = (f, n) if batch is None else (batch, f, n)
    frames = rng.standard_normal(shape).astype(np.float32)
    out_len = (f - 1) * hop + n
    w = get_window(WindowType.HANN, n, periodic=True)
    return frames, edge_norm(w, hop, f, out_len), out_len


@pytest.mark.parametrize("n,hop,f", [(1024, 256, 37), (512, 128, 100)])
@pytest.mark.parametrize("batch", [None, 3])
def test_b1_plain_bitexact_vs_pallas_and_reference(n, hop, f, batch):
    frames, norm, out_len = _case(n, hop, f, batch, seed=n + f)
    got = t_fused.ola_normalized_auto(
        torch.from_numpy(frames), torch.from_numpy(norm), hop, out_len
    ).numpy()
    pallas = np.asarray(ola_normalized_fused(
        jnp.asarray(frames), jnp.asarray(norm), hop, out_len, interpret=True
    ))
    ref = np.asarray(j_ola_norm(jnp.asarray(frames), hop, jnp.asarray(norm),
                                out_len))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,hop,f,out_len", [
    (1000, 256, 9, None),   # N not a hop multiple: zero-padded hop-blocks
    (512, 128, 12, 700),    # shorter than the span
    (256, 128, 5, 1000),    # longer than the span: zero tail
])
def test_overlap_add_edge_geometries(n, hop, f, out_len):
    rng = np.random.default_rng(f)
    frames = rng.standard_normal((2, f, n)).astype(np.float32)
    norm = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    length = out_len or (f - 1) * hop + n
    got = t_fused.ola_normalized_auto(
        torch.from_numpy(frames), torch.from_numpy(norm), hop, length
    ).numpy()
    want = np.asarray(j_ola_norm(jnp.asarray(frames), hop, jnp.asarray(norm),
                                 length))
    np.testing.assert_array_equal(got, want)
    assert t_overlap_add(torch.from_numpy(frames), hop, length).shape[-1] == length


def test_b1_eps_guard():
    frames = torch.ones((4, 256))
    got = t_fused.ola_normalized_auto(frames, torch.zeros(640), 128, 640, 0.5)
    assert torch.isfinite(got).all()
    assert torch.equal(got, t_overlap_add(frames, 128, 640) / 0.5)


def test_b1_wrapper_refuses_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel, whose wrapper checks the device and raises."""
    frames = torch.empty((2, 8, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.ola_normalized_auto(frames, torch.empty(1152, device="meta"),
                                    128, 1152)


@pytest.mark.parametrize("mode", ["CONSTANT", "REFLECT", "EDGE"])
@pytest.mark.parametrize("n,left,right", [(40, 8, 8), (40, 5, 0), (6, 11, 17),
                                          (1, 3, 2)])
def test_pad_signal_matches_reference(mode, n, left, right):
    if n == 1 and mode == "REFLECT":
        n = 2
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    got = t_pad(torch.from_numpy(x), left, right, TPadMode[mode], 0.25).numpy()
    want = np.asarray(j_pad(jnp.asarray(x), left, right, JPadMode[mode], 0.25))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,hop,center", [(1024, 256, True), (512, 128, False),
                                          (256, 100, True)])
def test_frame_signal_matches_reference(n, hop, center):
    x = np.random.default_rng(hop).standard_normal((2, 5000)).astype(np.float32)
    got = t_frame_signal(torch.from_numpy(x),
                         TFrameSpec(n, hop, center, TPadMode.REFLECT)).numpy()
    want = np.asarray(j_frame_signal(jnp.asarray(x),
                                     JFrameSpec(n, hop, center, JPadMode.REFLECT)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,hop,seed_len", [(128, 32, 96), (256, 128, 128),
                                            (1024, 256, 768)])
def test_overlap_add_init_head_matches_reference(n, hop, seed_len):
    """The seed is added before any frame, bit for bit as the reference."""
    from crlot_tpu.ola.reference import overlap_add as j_overlap_add

    rng = np.random.default_rng(n + seed_len)
    frames = rng.standard_normal((2, 9, n)).astype(np.float32)
    seed = rng.standard_normal((2, seed_len)).astype(np.float32)
    out_len = 8 * hop
    got = t_overlap_add(torch.from_numpy(frames), hop, out_len,
                        init_head=torch.from_numpy(seed)).numpy()
    want = np.asarray(j_overlap_add(jnp.asarray(frames), hop, out_len,
                                    init_head=jnp.asarray(seed)))
    np.testing.assert_array_equal(got, want)
    plain = t_overlap_add(torch.from_numpy(frames), hop, out_len).numpy()
    np.testing.assert_array_equal(got[:, seed_len:], plain[:, seed_len:])


@pytest.mark.parametrize("length", [4096, 1000])
def test_hop_block_frames_matches_reference(length):
    """Frame f = x[f*hop : f*hop + N], zero past the end of a short signal."""
    from crlot_tpu.frame.framing import hop_block_frames as j_hbf
    from crlot_tpu_torch.frame.framing import hop_block_frames as t_hbf

    x = np.random.default_rng(length).uniform(-1, 1, (2, length)).astype(
        np.float32)
    got = t_hbf(torch.from_numpy(x), 256, 64, 40).numpy()
    want = np.asarray(j_hbf(jnp.asarray(x), 256, 64, 40))
    assert got.shape == want.shape == (2, 40, 256)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "n,hop,margin",
    [(8, 2, 3), (8, 4, 2), (16, 4, 20), (1024, 256, 20), (1024, 512, 20),
     (100, 25, 5), (1000, 300, 4)],
)
def test_brute_force_norm_matches_reference(n, hop, margin):
    """The O(K*N) oracle: byte-identical to the reference's, and the port's
    `build_norm_linear` against it within the reference test's 1e-5."""
    from crlot_tpu.ola.norm import brute_force_norm as j_brute
    from crlot_tpu_torch.ola.norm import brute_force_norm, build_norm_linear

    w = get_window(WindowType.HANN, n, periodic=True)
    ring_len = (-(-n // hop) + margin) * hop
    got = brute_force_norm(w, ring_len, n, hop)
    want = j_brute(w, ring_len, n, hop)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    np.testing.assert_allclose(build_norm_linear(w, ring_len, n, hop), got,
                               atol=1e-5)
    with pytest.raises(ValueError):
        brute_force_norm(w, ring_len + 1, n, hop)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_edge_index_matches_reference(n):
    from crlot_tpu.core.padding import edge_index as j_edge_index
    from crlot_tpu_torch.core.padding import edge_index

    idx = np.arange(-12, 20)
    got = edge_index(torch.from_numpy(idx), n).numpy()
    want = np.asarray(j_edge_index(jnp.asarray(idx), n))
    np.testing.assert_array_equal(got, want)
