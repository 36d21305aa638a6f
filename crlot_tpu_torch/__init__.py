"""crlot-tpu-torch: crlot-tpu's round-trip, streaming, wire, resample, demo and analysis paths on PyTorch + CUDA.

A port of `crlot_tpu` (JAX on a TPU, kept beside it as the reference) to
PyTorch on an NVIDIA H100. Plain tensor code is torch; the Pallas kernels
of those paths are hand-written CUDA C++ for Hopper (`csrc/`),
built with nvcc at first use. Array-like input goes to the card unless the
caller passes `device="cpu"` (`core/device.py`). Importing this package
imports neither jax, crlot_tpu nor triton, and builds nothing. The
streaming layer (`Framer`, `OLAAccumulator`, `checkpoint`, `FftPlan`, the
sharded streamer) sits beside the round-trip paths, and so does the
analysis stack: `iir` (the log-depth scan IIR filters and their float64
designers), `effects` (pre/de-emphasis, mu-law), `features` (mel / MFCC,
spectral descriptors, chroma, pseudo-CQT, LPC, cepstrum, PCEN, the
Hilbert envelope, the mel inversion), `griffinlim`, `segment`, `psd`
(Welch PSD, coherence), `hpss`, `pitch` (YIN, onsets, tempo), `vocoder`
(time stretch, pitch shift) and `align` (DTW). Meshes can span processes
(`initialize`, `global_mesh`, `process_info`; the north-star `dryrun`), and
`profiling` holds the roofline, the trace scope and the NaN-debug mode.
Beside them, imported on demand: `io.native` (the C++ host runtime: WAV
codec, ring buffer, streaming framer; built with g++ at first use),
`bench` (the suite, stages, regression guard and duty probes) and
`examples` (the reference's eight, `python -m
crlot_tpu_torch.examples.<name>`).
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
    dryrun,
    global_mesh,
    initialize,
    make_mesh,
    process_info,
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
from .resample.stream import PolyphaseStreamer
from .convolve import convolve
from .streaming_pipeline import (
    BlockedChunkStreamer,
    ResampledStftStreamer,
    process_wav_file,
    streaming_round_trip,
)
from .wire import I16BlockedStreamer, i16_round_trip
from .window.windows import get_window

from .features import (
    amplitude_to_db,
    chroma,
    chroma_cqt,
    chroma_filterbank,
    cqt_filterbank,
    db_to_amplitude,
    db_to_power,
    delta,
    envelope,
    frame_rms,
    instantaneous_frequency,
    lpc,
    lpc_envelope_db,
    magphase,
    mel_filterbank,
    mel_spectrogram,
    mel_to_audio,
    mel_to_linear,
    mfcc,
    mfcc_to_mel,
    pcen,
    power_to_db,
    pseudo_cqt,
    real_cepstrum,
    spectral_bandwidth,
    spectral_centroid,
    spectral_contrast,
    spectral_flatness,
    spectral_rolloff,
    tonnetz,
    zero_crossing_rate,
)
from .segment import (
    activity_mask,
    frames_to_time,
    split_silence,
    time_to_frames,
    trim_silence,
)
from .effects import (
    deemphasis,
    mu_compress,
    mu_expand,
    mu_law_decode,
    mu_law_encode,
    preemphasis,
)
from .griffinlim import griffin_lim, stft_magnitude
from .iir import (
    a_weighting_sos,
    butter_sos,
    c_weighting_sos,
    lfilter,
    sosfilt,
    sosfilt_zi,
    sosfiltfilt,
)

from .psd import coherence, welch_freqs, welch_psd
from .hpss import harmonic, hpss, hpss_masks, percussive
from .pitch import detect_onsets, onset_strength, tempo, tempogram, yin_f0
from .vocoder import pitch_shift, time_stretch
from .align import dtw, dtw_cost, dtw_path

from . import (  # noqa: E402,F401
    align, checkpoint, convert, core, distributed, effects, features, fft,
    frame, griffinlim, iir, io, metrics, ola, pitch, profiling, psd, segment,
    spectral, vocoder, window,
)

__version__ = "0.1.0"
