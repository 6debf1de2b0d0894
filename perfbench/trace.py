"""What the device did in the traced window, from ``torch.profiler``.

The profiler records host operations on the thread that started it
only, while the runtime calls that launch device work (``cudaLaunch
Kernel``, ``cudaMemcpyAsync``, ...) are recorded on every thread.  So
the harness opens ``perfbench.window`` on its own thread around the
window, and marks each call of the distance + top-l step with a
one-element int16 fill before and after it (:func:`harness.step_marks`),
a kernel that nothing else launches.  From the events this module
takes:

``busy_s``         the union of the device's activity (kernels, copies,
                   sets) inside the window
``window_s``       the window's length on the trace's clock
``step_device_s``  the device time of the activities launched between
                   the launches of a step's two marks: each activity is
                   tied to the runtime call that launched it by its
                   correlation id
``device_ops``     the ten activities by name that took most time
``idle_gaps``      the device's idle time inside the window, by what the
                   serving thread was doing at each gap's middle: inside
                   a runtime call, or in Python after one (``python after
                   <call>``, ``python in step after <call>`` between a
                   step's marks), the ten largest
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

WINDOW = "perfbench.window"
MARK = "FillFunctor<short>"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@dataclass
class Ev:
    name: str
    device: bool          # an activity on the device (not a host event)
    start: float          # seconds on the trace's clock
    end: float
    thread: int = 0
    corr: int = 0         # correlation id (runtime calls and activities)


def from_profiler(prof) -> list:
    """The raw events of a stopped ``torch.profiler.profile``, read from
    its kineto result: the profiler's own parse into ``FunctionEvent``
    trees is slow at the window's hundreds of thousands of launches, and
    none of its trees is needed here."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        device = e.device_type() != DeviceType.CPU
        if device and (name.startswith("perfbench.")
                       or getattr(e, "is_user_annotation", bool)()):
            continue          # the ranges' device-side shadows
        start = e.start_ns() * 1e-9
        out.append(Ev(name, device, start, start + e.duration_ns() * 1e-9,
                      int(e.start_thread_id()), int(e.correlation_id())))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _where(host, steps, points):
    """For each time in ``points`` (ascending), what the serving thread
    was doing: the runtime call covering it, else Python after the last
    call that ended before it."""
    starts = [e.start for e in host]
    out = []
    for t in points:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and host[k].end >= t:
            out.append(host[k].name)
            continue
        where = "python"
        j = bisect.bisect_right(steps, (t, float("inf"))) - 1
        if j >= 0 and steps[j][0] <= t <= steps[j][1]:
            where += " in step"
        out.append(f"{where} after {host[k].name}" if k >= 0 else where)
    return out


def summarize(events, top: int = 10):
    """The window's numbers (module docstring) from the profiler's
    ``events``; None when the trace holds no window range or no device
    activity in it.  ``step_device_s`` is None unless the marks inside
    the window come from one thread in pairs."""
    wins = [e for e in events if not e.device and e.name == WINDOW]
    if not wins:
        return None
    w = wins[-1]
    w0, w1 = w.start, w.end
    dev = [e for e in events if e.device and e.end > w0 and e.start < w1]
    if not dev:
        return None
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in dev)
    busy_s = sum(e - s for s, e in busy)

    runtime = [e for e in events if not e.device and _RUNTIME.match(e.name)
               and e.end > w0 and e.start < w1]
    marked = {e.corr for e in dev if MARK in e.name}
    marks = sorted((e for e in runtime if e.corr in marked),
                   key=lambda e: e.start)
    threads = {e.thread for e in marks}
    sound = len(threads) == 1 and len(marks) % 2 == 0
    steps = ([(marks[i].end, marks[i + 1].start)
              for i in range(0, len(marks), 2)] if sound else [])
    serving = threads.pop() if len(threads) == 1 else None
    host = sorted((e for e in runtime if e.thread == serving),
                  key=lambda e: e.start)
    launched = set()
    for e in host:
        k = bisect.bisect_right(steps, (e.start, float("inf"))) - 1
        if k >= 0 and steps[k][0] <= e.start < steps[k][1]:
            launched.add(e.corr)
    step_s = (sum(e.end - e.start for e in events
                  if e.device and e.corr in launched) if sound else None)

    ops = {}
    for e in dev:
        ops[e.name] = ops.get(e.name, 0.0) + (e.end - e.start)
    device_ops = sorted(ops.items(), key=lambda x: -x[1])[:top]

    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    names = _where(host, steps, [m for m, _ in mids])
    idle = {}
    for (_, length), name in zip(mids, names):
        idle[name] = idle.get(name, 0.0) + length
    idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {"busy_s": busy_s, "window_s": w1 - w0, "step_device_s": step_s,
            "steps": len(steps), "step_launches": len(launched),
            "marks": len(marks),
            "device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[n, s] for n, s in idle_gaps]}
