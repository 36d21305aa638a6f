"""The kernel wrappers' launch counters, read, reset and put back.

Every kernel wrapper adds one to its counter where it launches its kernel.
The bench tooling times its calls by running them again and again, and
captures loops into CUDA graphs (the capture records launches that do not
run; a replay runs them without passing a wrapper). Those launches are not
counted: the tooling makes them inside `uncounted()`, which puts every
counter back as it found it, and `counting()` is False inside it, so that a
caller holding each counted launch against its plain version passes the
timed repeats by.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict

_depth = 0  # open uncounted() regions


@functools.lru_cache(maxsize=None)
def _wrappers() -> tuple:
    """The modules that hold the counters (imported on first use: they
    import this package's neighbours)."""
    from .. import int8_gemm
    from ..fft import fp32_window, fused_rt, tf32x3
    from ..ola import fused
    from ..ola import kernels as b5
    from ..resample import kernel as b4

    return tf32x3, fp32_window, fused, fused_rt, b4, b5, int8_gemm


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by kernel."""
    tf32x3, fp32_window, fused, fused_rt, b4, b5, b6 = _wrappers()
    b5, b6 = b5.launches, b6.launches
    return {"B0": tf32x3.launches, "B0_fp32": fp32_window.launches,
            "B1": fused.launches, "B2": fused_rt.launches,
            "B3": fused_rt.frames_launches, "B4": b4.launches,
            "K4": b5["axpy"], "K5": b5["axpy_windowed"],
            "K6": b5["normalize_and_clear"],
            **{f"B6_{k}": v for k, v in b6.items()}}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set every kernel wrapper's launch count to `counts[kernel]`."""
    tf32x3, fp32_window, fused, fused_rt, b4, b5, int8_gemm = _wrappers()
    tf32x3.launches, fp32_window.launches = counts["B0"], counts["B0_fp32"]
    fused.launches, fused_rt.launches = counts["B1"], counts["B2"]
    fused_rt.frames_launches, b4.launches = counts["B3"], counts["B4"]
    b5.launches.update(axpy=counts["K4"], axpy_windowed=counts["K5"],
                       normalize_and_clear=counts["K6"])
    for k in int8_gemm.launches:
        int8_gemm.launches[k] = counts[f"B6_{k}"]


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    set_launch_counts(dict.fromkeys(launch_counts(), 0))


def counting() -> bool:
    """False inside an `uncounted()` region."""
    return _depth == 0


@contextlib.contextmanager
def uncounted():
    """A region of timed repeats or graph captures: the launches made
    inside are taken back out of the counts on exit."""
    global _depth
    saved = launch_counts()
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        set_launch_counts(saved)
