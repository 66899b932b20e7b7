"""The traced run's reading of ``torch.profiler``: device activity from
the profiler's raw records (a window holds ~10^5 kernels; turning each
into a Python ``FunctionEvent`` costs ~30x this walk).

``busy_s`` is the union of every device interval (kernels, copies, sets)
over all streams, so the kernels of the pool's ten streams that overlap
count once; ``window_s`` is the traced sub-window on the profiler's clock.
The breakdown gives the device operations that took most time and the
idle gaps summed by what the host's main thread was doing at each gap's
middle (the innermost profiled op there, or the benchmark's own span
around an engine call when no op was running)."""
from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "perfbench.window"
TOP = 10


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    kernel_s: dict          # device op name -> total seconds
    kernel_n: dict          # device op name -> instances
    device_ops: list        # [[name, seconds], ...] longest first
    idle_gaps: list         # [[host activity, seconds], ...] longest first

    def seconds_of(self, part: str) -> float:
        return sum(s for k, s in self.kernel_s.items() if part in k)


def merge(intervals: list) -> list:
    """Union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_within(merged: list, lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps_within(merged: list, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] between ``merged``."""
    gaps, t = [], lo
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps: list, host: list) -> dict:
    """Seconds of idle time by the innermost host op (start, end, name)
    running at each gap's middle; ``host`` sorted by start."""
    starts = [h[0] for h in host]
    out: dict = collections.Counter()
    for s, e in gaps:
        m = 0.5 * (s + e)
        i = bisect.bisect_right(starts, m)
        name = "no host op"
        # the innermost op holding m started last among those holding it
        for j in range(i - 1, max(i - 4096, -1), -1):
            if host[j][1] >= m:
                name = host[j][2]
                break
        out[name] += (e - s)
    return out


def reduce_events(events, ns: float = 1e-9) -> TraceData:
    """``events``: (kind, start_ns, end_ns, name, thread) with kind
    "device" or "host"; the host span named ``WINDOW`` bounds the window
    and its thread is the main one."""
    dev, host, window, main = [], [], None, None
    names = collections.Counter()
    counts = collections.Counter()
    for kind, s, e, name, tid in events:
        if kind == "device":
            dev.append((s, e))
            names[name] += (e - s) * ns
            counts[name] += 1
        elif name == WINDOW:
            window, main = (s, e), tid
        else:
            host.append((s, e, name, tid))
    merged = merge(dev)
    if window is None:
        if not merged:
            raise RuntimeError("the profile holds no device activity")
        window = (merged[0][0], merged[-1][1])
    lo, hi = window
    busy = busy_within(merged, lo, hi) * ns
    main_ops = sorted(((s, e, n) for s, e, n, t in host
                       if main is None or t == main), key=lambda h: h[0])
    gaps = label_gaps(gaps_within(merged, lo, hi), main_ops)
    return TraceData(
        window_s=(hi - lo) * ns, busy_s=busy, kernel_s=dict(names),
        kernel_n=dict(counts),
        device_ops=[[k[:160], v] for k, v in names.most_common(TOP)],
        idle_gaps=[[k[:160], v * ns] for k, v in gaps.most_common(TOP)])


def kineto_events(prof):
    """(kind, start_ns, end_ns, name, thread) of a stopped profile."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        if ev.is_hidden_event():
            continue
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            annot = getattr(ev, "is_user_annotation", None)
            if (annot is not None and annot()) or name.startswith(
                    "perfbench.") or name == WINDOW:
                continue
            yield "device", s, e, name, None
        else:
            yield "host", s, e, name, ev.start_thread_id()


class Tracer:
    """Profiles one steady sub-window of a run: ``start()`` and ``stop()``
    are called on the main thread (between engine calls, or around a
    block of requests); ``span(name)`` marks a call into a layer of the
    program.  ``stop()`` only ends the profile: ``collect()`` reduces it
    to ``data`` once the run's timed work is over, so the walk over the
    profile's records lands in no timed call.  Disabled, every call is a
    no-op."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = bool(enabled)
        self.prof = None
        self._rf = None
        self.data: TraceData | None = None
        self.active = False

    def warm(self) -> None:
        """Bring up the profiler once in set-up: its first start
        initialises the device tracing, which takes seconds."""
        if not self.enabled:
            return
        self._profile().__enter__().__exit__(None, None, None)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def span(self, name: str):
        if not self.active:
            return _NULL
        return self.torch.profiler.record_function(f"perfbench.{name}")

    def start(self) -> None:
        if not self.enabled or self.prof is not None or self.data is not None:
            return
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self._rf = self.torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self._rf.__exit__(None, None, None)
        self.prof.stop()
        self.active = False

    def collect(self) -> None:
        """Stop the profile if it still runs, and reduce it to ``data``."""
        self.stop()
        if self.prof is not None:
            self.data = reduce_events(kineto_events(self.prof))
            self.prof = None

    def _sync(self) -> None:
        if self.torch.cuda.is_available() and self.torch.cuda.is_initialized():
            self.torch.cuda.synchronize()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
