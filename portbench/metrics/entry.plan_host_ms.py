"""entry.plan_host_ms: the host's time a call in the program's planning
stages, in ms: the self time of every `*.plan` and `*.consts` span of the
entry calls of the traced stretch (`crlot_tpu_torch.profiling.span`: the
route, the per-bin response, the window, the norms and the design
constants looked up), by the host clock, over the calls. The stretch's
calls are the last `steps` entry calls of `profiling.span_log()`: the
profiler stops right after the stretch's last step. Once the constants
are built these stages launch no device work, so with one call in flight
the card waits for all of it. Nothing when the run is untraced or the
program records no span."""

STAGES = (".plan", ".consts")


def plan_ms(records: list, steps: int, self_ns) -> float | None:
    """The mean over the last `steps` entry calls of `records` (span
    records in the order they were logged) of the stages' self time, in
    ms (`self_ns`: records -> {id: self time in ns}); None without an
    entry call."""
    calls = [r.call for r in records if r.parent is None][-steps:]
    if not calls:
        return None
    kept = set(calls)
    mine = [r for r in records if r.call in kept]
    own = self_ns(mine)
    ns = sum(own[r.id] for r in mine if r.name.endswith(STAGES))
    return 1e-6 * ns / len(calls)


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    from crlot_tpu_torch import profiling

    log = getattr(profiling, "span_log", None)
    if log is None:
        return None
    return plan_ms(log(), s["steps"], profiling.self_ns)
