"""The OLA SIMD tier (B5's plain versions) vs the reference on the CPU.

The reference holds its Pallas kernels to its jnp oracles within 1 ULP over
sizes straddling the 8x128 tile (`tests/test_kernels.py`). Here the port's
plain versions meet both -- the jnp oracle and the Pallas kernel in
interpret mode -- within the same 1 ULP, and in fact bit for bit: XLA
computes the multiply-add as one fused multiply-add, and so does the port.
"""

import numpy as np
import pytest
import torch

from crlot_tpu.ola import kernels as J

from crlot_tpu_torch import cuda_build
from crlot_tpu_torch.ola import kernels as K

SIZES = [1, 7, 15, 16, 17, 127, 128, 129, 1023, 1024, 1025, 4096, 16384]


def _ulp_diff(a, b) -> int:
    """Max bit-level ULP distance (same as tests/test_kernels.py)."""
    ai = np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, dtype=np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-(2**31)) - ai, ai)
    bi = np.where(bi < 0, np.int64(-(2**31)) - bi, bi)
    return int(np.max(np.abs(ai - bi))) if ai.size else 0


def _rand(n, seed):
    return np.random.default_rng(seed).uniform(-2, 2, n).astype(np.float32)


def _cases(name, n):
    if name == "axpy":
        dst, src = _rand(n, 1), _rand(n, 2)
        return (K.axpy(dst, src, 1.5), J.axpy_reference(dst, src, 1.5),
                J.axpy(dst, src, 1.5, use_pallas=True))
    if name == "axpy_windowed":
        dst, src, win = _rand(n, 3), _rand(n, 4), _rand(n, 5)
        return (K.axpy_windowed(dst, src, win, 0.75),
                J.axpy_windowed_reference(dst, src, win, 0.75),
                J.axpy_windowed(dst, src, win, 0.75, use_pallas=True))
    acc, norm = _rand(n, 6), np.abs(_rand(n, 7))
    norm[::5] = 0.0  # the eps guard
    got, cleared = K.normalize_and_clear(acc, norm, eps=1e-8)
    assert torch.equal(cleared, torch.zeros(n))
    return (got, J.normalize_and_clear_reference(acc, norm, 1e-8)[0],
            J.normalize_and_clear(acc, norm, eps=1e-8, use_pallas=True)[0])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["axpy", "axpy_windowed", "normalize"])
def test_plain_matches_reference_and_pallas(name, n):
    got, ref, pallas = _cases(name, n)
    got = got.numpy()
    assert got.shape == (n,)
    for want in (np.asarray(ref), np.asarray(pallas)):
        assert _ulp_diff(got, want) <= 1
        np.testing.assert_array_equal(got, want)  # expected: bit for bit


def test_fma_f32_is_one_rounding():
    """Cancelling terms expose a second rounding: fma_f32 matches a float64
    product and sum wherever those are exact, and differs from the
    two-rounding form there."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-2, 2, 4096).astype(np.float32)
    c = (-a * np.float32(1.5)).astype(np.float32)  # a*1.5 rounded: cancels
    c += rng.uniform(-1e-6, 1e-6, 4096).astype(np.float32)
    got = K.fma_f32(torch.from_numpy(a), 1.5, torch.from_numpy(c)).numpy()
    exact = (a.astype(np.float64) * 1.5 + c.astype(np.float64)).astype(
        np.float32)  # exact here: the terms are within a few binades
    np.testing.assert_array_equal(got, exact)
    assert not np.array_equal(got, c + a * np.float32(1.5))
    big = torch.tensor([3e38, np.inf, np.nan], dtype=torch.float32)
    out = K.fma_f32(big, 2.0, torch.zeros(3))
    assert torch.isinf(out[:2]).all() and torch.isnan(out[2])


def test_nan_in_norm_propagates_like_the_reference():
    acc = np.array([1.0, 1.0, 1.0, -2.0], np.float32)
    norm = np.array([np.nan, 0.0, 2.0, np.nan], np.float32)
    got, cleared = K.normalize_and_clear(acc, norm, eps=0.5)
    want, _ = J.normalize_and_clear_reference(acc, norm, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isnan(got[[0, 3]]).all() and float(got[1]) == 2.0
    assert torch.equal(cleared, torch.zeros(4))
    np.testing.assert_array_equal(acc, [1.0, 1.0, 1.0, -2.0])  # not zeroed


def test_semantics():
    np.testing.assert_allclose(
        K.axpy(np.array([1.0, 2.0], np.float32),
               np.array([10.0, 20.0], np.float32), 0.5).numpy(), [6.0, 12.0])
    np.testing.assert_allclose(
        K.axpy_windowed(np.zeros(3, np.float32),
                        np.array([1.0, 2.0, 3.0], np.float32),
                        np.array([0.5, 0.5, 0.0], np.float32), 2.0).numpy(),
        [1.0, 2.0, 0.0])
    out, _ = K.normalize_and_clear(np.array([1.0, 1.0], np.float32),
                                   np.array([0.0, 2.0], np.float32), eps=0.5)
    np.testing.assert_allclose(out.numpy(), [2.0, 0.5])
    two_d = K.axpy(torch.ones((2, 3)), torch.ones((2, 3)), 2.0)
    assert torch.equal(two_d, torch.full((2, 3), 3.0))


def test_empty_and_mismatch():
    empty = np.zeros(0, dtype=np.float32)
    assert K.axpy(empty, empty).numel() == 0
    assert K.axpy_windowed(empty, empty, empty).numel() == 0
    out, cleared = K.normalize_and_clear(empty, empty)
    assert out.numel() == cleared.numel() == 0
    with pytest.raises(ValueError):
        K.axpy(np.zeros(3, np.float32), np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        K.axpy_windowed(np.zeros(3, np.float32), np.zeros(3, np.float32),
                        np.zeros(2, np.float32))
    with pytest.raises(ValueError):
        K.normalize_and_clear(np.zeros(3, np.float32), np.zeros(2, np.float32))


def test_cpu_takes_the_plain_version_and_other_devices_the_kernel():
    """use_pallas never sends a CPU tensor to a kernel; a non-CPU tensor
    goes to the kernel's wrapper, which raises unless it is on CUDA, and
    use_pallas=False on it raises."""
    dst, src = _rand(100, 8), _rand(100, 9)
    for flag in (None, True, False):
        got = K.axpy(dst, src, 1.5, use_pallas=flag)
        assert torch.equal(got, K.axpy_reference(torch.from_numpy(dst),
                                                 torch.from_numpy(src), 1.5))
    assert K.launches == {"axpy": 0, "axpy_windowed": 0,
                          "normalize_and_clear": 0}
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.axpy(meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        K.axpy_windowed(meta, meta, meta, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.normalize_and_clear(meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        K.axpy(meta, torch.zeros(8))
    # A non-CPU tensor never takes the plain version, even when asked to.
    with pytest.raises(ValueError, match="use_pallas=False"):
        K.axpy(meta, meta, use_pallas=False)
    with pytest.raises(ValueError, match="use_pallas=False"):
        K.axpy_windowed(meta, meta, meta, use_pallas=False)
    with pytest.raises(ValueError, match="use_pallas=False"):
        K.normalize_and_clear(meta, meta, use_pallas=False)


def test_dispatch_info_on_the_cpu(capsys):
    info = K.kernel_dispatch_info()
    assert info["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert info["device_name"] == "cpu" and info["num_devices"] == 0
    assert info["kernels_built"] == (cuda_build._LIB is not None)
    assert "vpu_tile" not in info and "min_pallas_n" not in info
    K.print_kernel_dispatch_info()
    assert "kernels_built" in capsys.readouterr().out
    assert K.MAX_FRAME_SIZE == J.MAX_FRAME_SIZE
