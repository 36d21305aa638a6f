"""The work counts against the records: B0 at the main path, 2 x 5 627
windows of 2 048 at stride 512 and N 512 (70.8 G TF32 operations), B2 on
2 x 60 s (142 G)."""

from portbench import peaks, spec, work


def test_b0_main_path():
    c = spec.cell("multich64.eq_resident").config
    assert work.blocked_shape(c) == {"block": 512, "k": 2048}
    w = work.b0_clip(c, 2, 2_880_000)
    product = 3 * 2 * 2 * 5627 * 2048 * 512
    assert abs(product - 70.8e9) < 0.05e9
    assert 0 < w["ops"] - product < 0.002 * product  # the two edge patches
    t, by = work.bound_s(w, peaks.H100)
    assert by == "ops" and abs(t - 0.143e-3) < 0.001e-3


def test_b2_main_path():
    c = spec.cell("main48k.denoise_resident").config
    w = work.b2_clip(c, 2, 2_880_000)
    assert abs(w["ops"] - 142e9) < 0.5e9
    t, by = work.bound_s(w, peaks.H100)
    assert by == "ops" and abs(t - 0.286e-3) < 0.002e-3


def test_b0_stream_step_scales_with_the_chunk():
    c = spec.cell("config5.stream_1card").config
    one = work.b0_stream_step(c, 128, 1 << 20, 1)
    rows = -(-((1 << 20) + 2048) // 512)
    assert one["ops"] == 3 * 2 * 128 * rows * 2048 * 512
    four = work.b0_stream_step(c, 128, 4 << 20, 4)
    assert abs(four["ops"] / one["ops"] - 4) < 0.01


def test_peaks_refuse_an_unknown_card():
    import pytest

    assert peaks.of("NVIDIA H100 80GB HBM3") is peaks.H100
    with pytest.raises(ValueError):
        peaks.of("some other card")
