"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity, at the full power limit), copied here so that no change to the
program moves the yardstick."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s fp32 outside
# the tensor cores, 495 TF32, 989 bf16 / fp16, 1979 int8 and fp8; 700 W.
H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "power_w": 700.0,
}


def of(kind: str) -> dict:
    """The peaks of the card named `kind` (`torch.cuda.get_device_name`).
    Raises for a card whose peaks are not written here: a roofline share
    against a guess would mean nothing."""
    if "H100" in kind:
        return H100
    raise ValueError(f"no published peaks for {kind!r}")
