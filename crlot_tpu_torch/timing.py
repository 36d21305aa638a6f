"""CUDA-event timing of a call on the card, queued behind a busy card.

Shared by `chip_smoke.py` and `python -m crlot_tpu_torch.int8_probe`.
"""

from __future__ import annotations

import statistics

REPS = 10
SLEEP_CYCLES = 100_000_000  # ~50 ms of the card's clock: queue-ahead time
FLUSH_BYTES = 256 * 2**20  # written before each cold run: 5x the 50 MB L2


def cuda_ms(fn, reps: int = REPS, cold: bool = False) -> tuple:
    """(queued, per call): median device time of fn over `reps` runs after
    two warm-ups (ms), timed two ways.

    Queued: the card is first kept busy (`torch.cuda._sleep`) while the
    host enqueues all runs, so each event pair brackets the device's work
    and not the host's time to launch it (tens of microseconds of Python
    per call, as long as a short kernel). An event recorded after the
    sleep must still be pending once the last run is queued. If it is not,
    the host fell behind the card, and the runs are timed again behind a
    sleep four times as long; if the host falls behind again, queued is
    None. (A call of many hundred launches can fill CUDA's launch queue,
    and the host then waits for the card, however long it sleeps.)
    Per call: each run alone, synchronized after it, so the host's launch
    time counts where it exceeds the device's work.
    Cold: before each timed run, outside its event pair, FLUSH_BYTES of
    scratch are written, so that fn finds its inputs in device memory and
    not in L2 (warm, a run reads what the run before it left in L2)."""
    import torch

    scratch = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
               if cold else None)

    def run(e0, e1):
        if scratch is not None:
            scratch.fill_(1)
        e0.record()
        fn()
        e1.record()

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    queued, cycles = None, SLEEP_CYCLES
    for _ in range(2):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        woke = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        woke.record()
        for e0, e1 in pairs:
            run(e0, e1)
        behind = woke.query()
        torch.cuda.synchronize()
        if not behind:
            queued = statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)
            break
        cycles *= 4
    per_call = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        run(e0, e1)
        e1.synchronize()
        per_call.append(e0.elapsed_time(e1))
    return queued, statistics.median(per_call)
