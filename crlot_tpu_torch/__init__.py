"""crlot-tpu-torch: crlot-tpu's round-trip, streaming, wire, resample and demo paths on PyTorch + CUDA.

A port of `crlot_tpu` (JAX on a TPU, kept beside it as the reference) to
PyTorch on an NVIDIA H100. Plain tensor code is torch; the Pallas kernels
of those paths are hand-written CUDA C++ for Hopper (`csrc/`),
built with nvcc at first use. Array-like input goes to the card unless the
caller passes `device="cpu"` (`core/device.py`). Importing this package
imports neither jax, crlot_tpu nor triton, and builds nothing. The
streaming layer (`Framer`, `OLAAccumulator`, `checkpoint`, `FftPlan`, the
sharded streamer) sits beside the round-trip paths.
"""

from .core.types import (
    BoundaryMode,
    FftBackend,
    FftDomain,
    FftPlanDesc,
    FftPrecision,
    FrameSpec,
    NormalizationType,
    OLAConfig,
    PadMode,
    StftConfig,
    WindowType,
)
from .distributed import (
    ShardedStreamer,
    auto_mesh,
    make_mesh,
    metrics_report,
    sharded_round_trip,
    sharded_stream,
    sharded_stream_iter,
)
from .fft.api import FftPlan, make_fft_plan
from .frame.framing import frame_signal, frame_windowed, num_frames
from .frame.streaming import Framer
from .io.wav import WavReader, WavWriter, read_wav, write_wav
from .metrics import PeakMeter, snr_db, xcorr_delay_ms
from .ola.streaming import OLAAccumulator
from .ola.reference import overlap_add, overlap_add_normalized
from .pipeline import formulation_for, istft, resampled_stft, round_trip, stft
from .resample.polyphase import resample, resample_chunked
from .convolve import convolve
from .streaming_pipeline import (
    BlockedChunkStreamer,
    process_wav_file,
    streaming_round_trip,
)
from .wire import I16BlockedStreamer, i16_round_trip
from .window.windows import get_window

from . import (  # noqa: E402,F401
    checkpoint, convert, core, distributed, fft, frame, io, metrics, ola,
    spectral, window,
)

__version__ = "0.1.0"
