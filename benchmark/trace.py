"""The traced run: torch.profiler over the window, read from its raw
events (the profiler's own per-op tables are never built, so reading
stays fast at a few hundred thousand kernels).

`Trace` holds the device operations (kernels, copies and sets, each
with its start and length on the device's clock), the harness's host
spans (`train_step`, `generate_call`, `between_calls`) and every other
host range (`record_function` names such as the MoE layer's `moe.*`),
and the host thread and time at which each device operation was issued.
"""

from __future__ import annotations

import bisect
from contextlib import contextmanager, nullcontext

import torch

SPANS = ("train_step", "generate_call", "between_calls")


def span(name: str, traced: bool):
    """A harness span around host work; a no-op when not traced."""
    if not traced:
        return nullcontext()
    from torch.autograd.profiler import record_function

    return record_function(name)


@contextmanager
def profiled(out: list):
    """Profile the block (CPU and CUDA); appends a `Trace` to `out`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    out.append(Trace(prof.profiler.kineto_results.events()))


class Trace:
    def __init__(self, events):
        from torch.autograd import DeviceType

        self.ops = []        # (start_ns, end_ns, name, correlation id)
        self.spans = []      # harness spans: (start_ns, end_ns, name)
        self.ranges = []     # other host ranges: (start, end, name, thread)
        issued = {}          # correlation id -> (host ns, thread)
        for e in events:
            start, length = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.ops.append((start, start + length, e.name(),
                                     e.correlation_id()))
                continue
            if e.is_user_annotation():
                if e.name() in SPANS:
                    self.spans.append((start, start + length, e.name()))
                else:
                    self.ranges.append((start, start + length, e.name(),
                                        e.start_thread_id()))
            elif e.correlation_id():
                issued[e.correlation_id()] = (start, e.start_thread_id())
        self.ops.sort()
        self.spans.sort()
        self.issued = issued
        first = self.spans[0][0] if self.spans else (
            self.ops[0][0] if self.ops else 0)
        last = max([s[1] for s in self.spans] + [o[1] for o in self.ops]
                   + [first])
        self.window = (first, last)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, merged."""
        merged = []
        for start, end, _, _ in self.ops:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(e - s for s, e, name, _ in self.ops if match(name)) / 1e9

    def op_count(self, match) -> int:
        return sum(1 for _, _, name, _ in self.ops if match(name))

    def by_name(self, top: int = 10) -> list:
        """[[name, device seconds]] of the operations that took most."""
        total: dict = {}
        for s, e, name, _ in self.ops:
            total[name] = total.get(name, 0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in ranked]

    def seconds_under(self, prefix: str) -> float:
        """Device seconds of the operations issued, on its own thread,
        inside a host range whose name starts with `prefix`."""
        ranges: dict = {}
        for start, end, name, thread in self.ranges:
            if name.startswith(prefix):
                ranges.setdefault(thread, []).append((start, end))
        for spans in ranges.values():
            spans.sort()
        starts = {t: [s for s, _ in v] for t, v in ranges.items()}
        total = 0
        for s, e, _, corr in self.ops:
            host = self.issued.get(corr)
            if host is None or host[1] not in ranges:
                continue
            i = bisect.bisect_right(starts[host[1]], host[0]) - 1
            if i >= 0 and ranges[host[1]][i][1] >= host[0]:
                total += e - s
        return total / 1e9

    def host_span_at(self, t: int) -> str:
        """The harness span the host was in at time t (innermost)."""
        found = "outside"
        for start, end, name in self.spans:
            if start > t:
                break
            if end >= t:
                found = name
        return found

    def idle_gaps(self, top: int = 10) -> list:
        """[[host span, seconds]] of the longest device idle gaps inside
        the window, each named by what the host was doing then."""
        gaps, cursor = [], self.window[0]
        for start, end in self.busy_intervals():
            if start > cursor:
                gaps.append((start - cursor, cursor))
            cursor = max(cursor, end)
        if self.window[1] > cursor:
            gaps.append((self.window[1] - cursor, cursor))
        gaps.sort(reverse=True)
        return [[self.host_span_at(at + length // 2), length / 1e9]
                for length, at in gaps[:top]]

    def breakdown(self) -> dict:
        return {"device_ops": self.by_name(), "idle_gaps": self.idle_gaps()}


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


__all__ = ["SPANS", "Trace", "profiled", "span", "sync"]
