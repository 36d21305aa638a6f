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
