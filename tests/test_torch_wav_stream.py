"""`process_wav_file` and `WavWriter` at bounded memory (ROADMAP C11).

The file-to-file stream reads each chunk's span through `WavStreamReader`
(seek + read_chunk, never the whole file) and `WavWriter` encodes each
block to disk at `write`, patching the RIFF and data sizes at `close`. The
bytes must equal what `write_wav` makes of the whole output at once, and
what the reference package's `write_wav` makes of it (the writer the port's
was copied from, untouched).
"""

from __future__ import annotations

import numpy as np
import pytest

import crlot_tpu_torch as pt
from crlot_tpu.io import wav as ref_wav
from crlot_tpu_torch.io import wav


def _noise(shape, seed, scale=0.8):
    return np.random.default_rng(seed).uniform(-scale, scale, shape).astype(
        np.float32)


def _stream_reference(data, cfg, block_frames, blocks_per_chunk):
    """The unbroken stream of each channel, as `process_wav_file` computes
    it, written once by `write_wav`'s encoding."""
    hop, n = cfg.hop_size, cfg.frame_size
    chunk = block_frames * blocks_per_chunk * hop
    frames = -(-data.shape[-1] // chunk) * (chunk // hop)
    need = (frames - 1) * hop + n
    xp = np.pad(data, [(0, 0), (0, need - data.shape[-1])])
    return np.stack([
        pt.streaming_round_trip(xp[c], cfg, block_frames=block_frames,
                                device="cpu")[0][: data.shape[-1]]
        for c in range(data.shape[0])])


def test_process_wav_file_streams_and_writes_todays_bytes(tmp_path,
                                                          monkeypatch):
    """A 2-channel 16-bit file of several chunks: the output file is byte
    for byte `write_wav` of the unbroken stream; the reader never decodes
    the whole file (read_wav is not called, no read asks for more than a
    chunk's span) and the writer holds no block."""
    cfg = pt.StftConfig(frame_size=256, hop_size=64, center=False)
    block_frames, blocks_per_chunk = 8, 2
    span = (block_frames * blocks_per_chunk - 1) * 64 + 256
    src = _noise((2, 5 * 1024 + 77), 0)
    infile, outfile = tmp_path / "in.wav", tmp_path / "out.wav"
    pt.write_wav(str(infile), src, 48000, bits=16)
    data, _ = pt.read_wav(str(infile))

    asked, held = [], []
    real_read, real_write = wav.WavStreamReader.read_chunk, wav.WavWriter.write

    def read_chunk(self, frames):
        asked.append(frames)
        return real_read(self, frames)

    def write(self, block):
        real_write(self, block)
        held.append(getattr(self, "_blocks", None))

    def no_whole_file(*a, **k):
        raise AssertionError("the whole file was decoded")

    monkeypatch.setattr(wav.WavStreamReader, "read_chunk", read_chunk)
    monkeypatch.setattr(wav.WavWriter, "write", write)
    monkeypatch.setattr(wav, "read_wav", no_whole_file)
    n = pt.process_wav_file(str(infile), str(outfile), cfg,
                            block_frames=block_frames,
                            blocks_per_chunk=blocks_per_chunk, device="cpu")
    monkeypatch.undo()
    assert n == data.shape[-1]
    assert len(asked) > 4 and max(asked) == span
    assert held and all(h is None for h in held)
    want = _stream_reference(data, cfg, block_frames, blocks_per_chunk)
    ref, ref_jax = tmp_path / "ref.wav", tmp_path / "ref_jax.wav"
    wav.write_wav(str(ref), want, 48000, bits=16)
    ref_wav.write_wav(str(ref_jax), want, 48000, bits=16)
    assert outfile.read_bytes() == ref.read_bytes() == ref_jax.read_bytes()


@pytest.mark.parametrize("channels,bits,float_format,lengths", [
    (2, 16, False, [1000, 1, 2047]),
    (1, 24, False, [333, 1, 1000]),    # odd data size: the pad byte
    (2, 24, False, [10, 0, 99]),
    (2, 32, False, [500, 501]),
    (1, 16, True, [7, 4096]),          # float32 passthrough
    (2, 8, True, [64, 65]),            # bits ignored for float
])
def test_wav_writer_streams_write_wavs_bytes(tmp_path, channels, bits,
                                             float_format, lengths):
    """Blocks written one by one equal `write_wav` of their concatenation,
    byte for byte (clipped samples included), and the file on disk grows
    at each write while the writer keeps no block."""
    scale = 0.9 if bits == 32 and not float_format else 1.2  # clip 16/24
    blocks = [_noise((channels, k), 10 + k, scale) for k in lengths]
    path, ref = tmp_path / "w.wav", tmp_path / "ref.wav"
    sizes = []
    with wav.WavWriter(str(path), channels, 44100, bits=bits,
                       float_format=float_format) as w:
        for b in blocks:
            w.write(b if channels > 1 else b[0])
            assert not hasattr(w, "_blocks")
            w._f.flush()
            sizes.append(path.stat().st_size)
    wav.write_wav(str(ref), np.concatenate(blocks, axis=1), 44100, bits=bits,
                  float_format=float_format)
    ref_jax = tmp_path / "ref_jax.wav"
    ref_wav.write_wav(str(ref_jax), np.concatenate(blocks, axis=1), 44100,
                      bits=bits, float_format=float_format)
    assert path.read_bytes() == ref.read_bytes() == ref_jax.read_bytes()
    width = 4 if float_format else bits // 8
    assert sizes == [44 + channels * width * sum(lengths[: i + 1])
                     for i in range(len(lengths))]


def test_wav_writer_empty_and_refusals(tmp_path):
    """An empty stream is a valid empty WAV, as `write_wav` writes it; a
    bad format is refused at open, a wrong channel count at write, and a
    write after close."""
    path, ref = tmp_path / "e.wav", tmp_path / "ref.wav"
    wav.WavWriter(str(path), 2, 16000).close()
    ref_wav.write_wav(str(ref), np.zeros((2, 0), np.float32), 16000)
    assert path.read_bytes() == ref.read_bytes()
    with pytest.raises(wav.WavFormatError):
        wav.WavWriter(str(tmp_path / "a.wav"), 3, 16000)
    with pytest.raises(wav.WavFormatError):
        wav.WavWriter(str(tmp_path / "b.wav"), 1, 16000, bits=12)
    with pytest.raises(ValueError):
        wav.WavWriter(str(tmp_path / "c.wav"), 1, 0)
    w = wav.WavWriter(str(tmp_path / "d.wav"), 2, 16000)
    with pytest.raises(ValueError, match="channels"):
        w.write(np.zeros((1, 4), np.float32))
    w.close()
    w.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        w.write(np.zeros((2, 4), np.float32))
