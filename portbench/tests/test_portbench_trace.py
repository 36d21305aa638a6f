"""The trace arithmetic on synthetic event lists."""

from portbench import trace

STEP = trace.STEP


def test_union_merges_and_clips():
    got = trace.union([(5, 8), (0, 3), (2, 4), (7, 12)], 1, 10)
    assert got == [[1, 4], [5, 10]]


def test_gaps_are_the_complement():
    assert trace.gaps([[1, 4], [5, 10]], 0, 12) == [(0, 1), (4, 5), (10, 12)]


def test_summary_of_two_steps():
    host = [(STEP, 0.0, 100.0), (STEP, 100.0, 200.0), (STEP, 200.0, 300.0),
            ("aten::cat", 10.0, 30.0), ("cudaDeviceSynchronize", 60.0, 100.0),
            ("cudaDeviceSynchronize", 160.0, 200.0)]
    dev = [("b6_sm90_kernel<8>", 20.0, 60.0), ("copy", 50.0, 70.0),
           ("b6_sm90_kernel<8>", 120.0, 160.0), ("nccl:send", 150.0, 170.0),
           ("late", 250.0, 260.0)]
    s = trace.summarize(dev, host, 0, 2)
    assert s["steps"] == 2
    assert abs(s["window_s"] - 200e-6) < 1e-12
    assert abs(s["busy_s"] - 100e-6) < 1e-12  # [20, 70] and [120, 170]
    assert abs(trace.seconds_matching(s, ("b6_sm90",)) - 80e-6) < 1e-12
    idle = s["idle_s_by_host_op"]
    assert abs(idle[trace.PYTHON] - 20e-6) < 1e-12  # [0, 20]
    # [70, 120] and [170, 200] begin inside a synchronize
    assert abs(idle["cudaDeviceSynchronize"] - 80e-6) < 1e-12
    assert trace.top(s["device_s_by_name"], k=1)[0][0] == "b6_sm90_kernel<8>"


def test_stretch_skips_the_lead_steps():
    host = [(STEP, float(10 * i), float(10 * i + 9)) for i in range(6)]
    assert trace.stretch(host, 3, 2) == (30.0, 49.0, 2)
    assert trace.stretch(host, 7, 2) is None
    assert trace.summarize([], host, 7, 2) == {"steps": 0}
