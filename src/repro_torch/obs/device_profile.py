"""The card's kernel events of a call, from ``torch.profiler``.

``profile_calls`` names the device events a call makes and how long the
ones of interest take.  The profiler may miss short events (after long
sessions, every event of a window), never add one, so a window with no
event is profiled again and counts a call are at most the truth."""

from __future__ import annotations

#: profiled windows a measurement tries before it reports what it has
PROFILE_ATTEMPTS = 5


def profile_calls(fn, reps: int, name: str | None = None) -> tuple[dict[str, float], float]:
    """torch.profiler's device events of ``reps`` calls of ``fn()``: their
    names (without "void", namespaces and arguments), each with its count a
    call, and the mean milliseconds of the events whose names hold
    ``name`` (0.0 where none).  A window with no event (none holding
    ``name``, when given) is profiled again, up to ``PROFILE_ATTEMPTS``
    windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        us = [t for n, t in events if name is not None and name in n]
        if us or (name is None and events):
            break
    counts: dict[str, int] = {}
    for n, _ in events:
        n = n.replace("(anonymous namespace)::", "").split("(")[0]
        n = n.removeprefix("void ").strip()
        counts[n] = counts.get(n, 0) + 1
    return {n: c / reps for n, c in counts.items()}, (sum(us) / len(us) / 1e3 if us else 0.0)
