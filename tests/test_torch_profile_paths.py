"""The profiling script's pieces on the CPU (its full run needs a card)."""

import torch

from crlot_tpu_torch import profile_paths as P


def test_profile_call_on_the_cpu_measures_no_device_time():
    x = torch.arange(1000, dtype=torch.float32)
    out = P.profile_call("sum", lambda: x.sum(), torch.device("cpu"))
    assert out.startswith("== sum: end to end ")
    assert out.endswith("device not measured")


def test_report_orders_device_events_and_gives_the_idle_share():
    rows = {"small": [10, 100.0], "big": [5, 900.0]}
    out = P._report("call", 0.004, rows, 5, torch.device("cuda"))
    head, big, small = out.splitlines()
    # 1000 us over 5 runs = 0.2 ms of device time in a 4 ms call.
    assert head == ("== call: end to end 4.0000 ms, device 0.2000 ms, "
                    "idle share 0.950")
    assert big.split() == ["0.1800", "ms", "x1", "big"]
    assert small.split() == ["0.0200", "ms", "x2", "small"]


def test_accumulator_row_reconstructs_its_input():
    """The Framer + OLAAccumulator row on the CPU: one frame a hop, drained
    a hop at a time, then flushed; the interior is the input."""
    import numpy as np

    from crlot_tpu_torch.metrics import snr_db

    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 9600)).astype(np.float32))
    y = torch.cat(P._ola_stream(x, 0.2, torch.device("cpu")), dim=1)
    span = (9600 - 1024) // 256 * 256 + 1024  # the full frames' span
    assert tuple(y.shape) == (2, span)
    assert snr_db(x[:, 1024:span - 1024], y[:, 1024:span - 1024]) > 100
