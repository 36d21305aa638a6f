"""Config types for the PyTorch port: the STFT pipeline's, the streaming
OLA accumulator's and the FFT plan's frozen configs.

Counterpart of `crlot_tpu/core/types.py`. The enums keep the reference's
member names and `.value` strings, so `convert.config_from_reference` can map
a `crlot_tpu` config field by field. Configs are frozen and hashable: they key
the host-side constant caches.

Precision on CUDA: `FftPrecision.HIGH` (the default) means 3xTF32 on the
tensor cores in B0 (the blocked round-trip's and `convolve`'s windowed
product, the scan form's composed product), B2 and B3 (the fused nonlinear
round-trip): each f32 operand split into TF32 hi + lo, three TF32 products
summed in f32, the reference's own tier (its 3-pass bf16 split on the TPU).
`HIGHEST` means IEEE fp32 (B0's fixed-order fp32 kernel for the windowed
product, `torch.matmul` elsewhere; the fused routes are gated on HIGH).
TF32 appears only inside those kernels, by name:
`torch.backends.cuda.matmul.allow_tf32` stays False. On the CPU every float
product runs IEEE fp32. `INT8X2` is the reference's int8 DFT tier
(`fft/int8_backend.py`): the tiled round-trip runs its products as two int8
limbs a value on K11's kernel (`int8_gemm.fusedq_ref_gemm`; its plain
version on the CPU), and every other lowering runs it as HIGH
(`float_tier`), as the reference's `fft/dispatch.to_lax_precision` does.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class WindowType(enum.Enum):
    HANN = "hann"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackman_harris"
    RECT = "rect"


class NormalizationType(enum.Enum):
    NONE = "none"
    SUM_TO_ONE = "sum_to_one"
    L2_NORM = "l2_norm"
    OLA_UNITY_GAIN = "ola_unity_gain"
    OLA_SUM_WSQ = "ola_sum_wsq"


class PadMode(enum.Enum):
    """Centered-framing pad modes; REFLECT is non-repeating reflect101:
    [1,2,3,4] -> ...3,2,[1,2,3,4],3,2,..."""

    CONSTANT = "constant"
    REFLECT = "reflect"
    EDGE = "edge"


class BoundaryMode(enum.Enum):
    """Streaming framer tail policy: ZERO_PAD releases one zero-filled
    partial frame after `flush`, DROP refuses partial frames."""

    ZERO_PAD = "zero_pad"
    DROP = "drop"


class FftDomain(enum.Enum):
    """FFT plan domain."""

    REAL = "real"
    COMPLEX = "complex"


class FftPrecision(enum.Enum):
    """HIGH is 3xTF32 on the tensor cores (B0, B2, B3) on CUDA, HIGHEST
    IEEE fp32; both IEEE fp32 on the CPU. INT8X2 is the reference's int8
    two-limb DFT tier: the tiled round-trip's products on K11, HIGH
    elsewhere."""

    HIGHEST = "highest"
    HIGH = "high"
    INT8X2 = "int8x2"


def float_tier(precision: FftPrecision) -> FftPrecision:
    """The tier a float product runs at: INT8X2 has an int8 formulation only
    in the tiled round-trip, and runs every other product as HIGH."""
    return FftPrecision.HIGH if precision == FftPrecision.INT8X2 else precision


class FftBackend(enum.Enum):
    """XLA = library FFT (`torch.fft`). MATMUL = DFT as folded matrix
    products. AUTO = MATMUL on a CUDA tensor, `torch.fft` on a CPU tensor."""

    AUTO = "auto"
    XLA = "xla"
    MATMUL = "matmul"


@dataclass(frozen=True)
class FrameSpec:
    frame_size: int
    hop_size: int
    center: bool = False
    pad_mode: PadMode = PadMode.CONSTANT
    pad_value: float = 0.0

    def __post_init__(self) -> None:
        if self.frame_size <= 0:
            raise ValueError(f"frame_size must be > 0, got {self.frame_size}")
        if self.hop_size <= 0:
            raise ValueError(f"hop_size must be > 0, got {self.hop_size}")

    @property
    def pad_amount(self) -> int:
        return self.frame_size // 2 if self.center else 0

    @property
    def tail(self) -> int:
        return max(self.frame_size - self.hop_size, 0)

    def num_frames(self, signal_len: int) -> int:
        """Max n with n*hop + tail <= padded_len."""
        padded = signal_len + 2 * self.pad_amount
        if padded < self.frame_size:
            return 0
        return (padded - self.tail) // self.hop_size


@dataclass(frozen=True)
class FftPlanDesc:
    """FFT plan descriptor: REAL plans need an even nfft, in-place
    transforms are not supported, batch and strides are >= 1. The batch is
    not capped (`FftPlan.max_batch_size`)."""

    domain: FftDomain
    nfft: int
    in_place: bool = False
    batch: int = 1
    stride_in: int = 1
    stride_out: int = 1
    scrub: bool = True  # NaN/Inf -> 0 and |x| < 1e-30 -> 0
    backend: FftBackend = FftBackend.AUTO

    def __post_init__(self) -> None:
        if self.nfft <= 0:
            raise ValueError(f"nfft must be > 0, got {self.nfft}")
        if self.domain == FftDomain.REAL and self.nfft % 2 != 0:
            raise ValueError(
                f"REAL domain requires even nfft, got {self.nfft}")
        if self.in_place:
            raise ValueError("in_place transforms are not supported")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.stride_in < 1 or self.stride_out < 1:
            raise ValueError("strides must be >= 1")

    @property
    def num_bins(self) -> int:
        """Output bins of the REAL forward transform (n/2+1)."""
        return self.nfft // 2 + 1


@dataclass(frozen=True)
class OLAConfig:
    """Streaming overlap-add accumulator config. The ring holds
    ceil(N/H) + `ring_margin_hops` hops."""

    sample_rate: int
    frame_size: int
    hop_size: int
    channels: int = 1
    eps: float = 1e-8
    apply_window_inside: bool = True
    ring_margin_hops: int = 20

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError(
                f"sample_rate must be > 0, got {self.sample_rate}")
        if self.frame_size <= 0:
            raise ValueError(f"frame_size must be > 0, got {self.frame_size}")
        if self.hop_size <= 0:
            raise ValueError(f"hop_size must be > 0, got {self.hop_size}")
        if self.hop_size > self.frame_size:
            raise ValueError(
                f"hop_size ({self.hop_size}) must be <= frame_size "
                f"({self.frame_size})"
            )
        if self.channels <= 0:
            raise ValueError(f"channels must be > 0, got {self.channels}")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")

    @property
    def overlap_count(self) -> int:
        """Max frames covering one sample: ceil(frame/hop)."""
        return -(-self.frame_size // self.hop_size)

    @property
    def ring_len(self) -> int:
        """Hop-aligned ring length: (ceil(N/H) + margin) * H."""
        return (self.overlap_count + self.ring_margin_hops) * self.hop_size


@dataclass(frozen=True)
class StftConfig:
    """STFT/iSTFT pipeline config with single-window discipline: the
    analysis window is applied once, and the OLA divides by the matching
    COLA sum (sum w, or sum w^2 with a synthesis window)."""

    frame_size: int
    hop_size: int
    window: WindowType = WindowType.HANN
    periodic: bool = True
    synthesis_window: bool = False
    center: bool = False
    pad_mode: PadMode = PadMode.REFLECT
    eps: float = 1e-8
    fft_backend: FftBackend = FftBackend.AUTO
    fft_precision: FftPrecision = FftPrecision.HIGH
    # Opt-in: the identity round_trip through the frames-level fused
    # kernel (B3) and the fused OLA (B1), route "fused_rt_frames".
    fused_roundtrip: bool = False

    def __post_init__(self) -> None:
        if self.frame_size <= 0 or self.frame_size % 2 != 0:
            raise ValueError(
                f"frame_size must be positive and even, got {self.frame_size}"
            )
        if self.hop_size <= 0 or self.hop_size > self.frame_size:
            raise ValueError(
                f"hop_size must be in [1, frame_size], got {self.hop_size}"
            )

    @property
    def frame_spec(self) -> FrameSpec:
        return FrameSpec(
            frame_size=self.frame_size,
            hop_size=self.hop_size,
            center=self.center,
            pad_mode=self.pad_mode,
        )

    @property
    def num_bins(self) -> int:
        return self.frame_size // 2 + 1
