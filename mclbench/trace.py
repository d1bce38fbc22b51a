"""The traced run: torch.profiler over a short steady part of the window,
and what the per-layer metrics read from it.

Host spans are the benchmark's own (`span`, named "mclbench:<what>"),
around its calls into the program; device operations (kernels, copies,
fills) are the profiler's device events.  Both come on the profiler's
clock.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

PREFIX = "mclbench:"


def span(name: str):
    """A host span for the profile (a no-op outside one)."""
    return torch.profiler.record_function(PREFIX + name)


class Profile:
    """One profiler session over the traced part of the window."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def warm_up(self) -> None:
        """Start and stop a throw-away session, in set-up: the first
        session's start initializes the profiler's libraries, which takes
        seconds."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with torch.profiler.profile(activities=self._prof.activities):
                pass

    def stop(self) -> None:
        self._prof.stop()

    def events(self):
        """After stop: (device ops, host spans), each a list of (name,
        start ns, end ns)."""
        ops, spans = [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if hasattr(e, "start_ns"):
                start = e.start_ns()
                end = start + e.duration_ns()
            else:
                start = int(e.start_us() * 1000)
                end = start + int(e.duration_us() * 1000)
            on_device = "CUDA" in str(e.device_type())
            if name.startswith(PREFIX):
                # A span also shows on the device's timeline as an
                # annotation; the host's copy is the span.
                if not on_device:
                    spans.append((name[len(PREFIX):], start, end))
            elif on_device:
                ops.append((name, start, end))
        ops.sort(key=lambda o: o[1])
        return ops, spans


def union(intervals) -> list:
    """Merged [start, end) intervals of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered_ns(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


@dataclasses.dataclass
class Reading:
    """What a traced run gives the metric readers.

    ops       device operations (name, start ns, end ns) in the window
    spans     the benchmark's host spans (name, start ns, end ns)
    window    (start ns, end ns) of the traced window
    ticks     filter ticks the window ran (a fleet frame is one tick)
    service_ms  the time of each frame outside the profile from its line
              handed to the server to its reply written (fleet)
    latency_ms  the latency of each frame outside the profile, from its
              due time to its reply written; inf for a failed frame
              (fleet)
    bounds    the yardstick's least device ms a tick for the kernels
              (k1_ms_per_tick, k3_ms_per_tick) on the inputs the traced
              window saw, worked out by `settle` once the run's memory
              peak has been read
    """

    ops: list
    spans: list
    window: tuple
    ticks: int
    service_ms: list = dataclasses.field(default_factory=list)
    latency_ms: list = dataclasses.field(default_factory=list)
    bounds: dict = dataclasses.field(default_factory=dict)
    pending: Optional[Callable[[], dict]] = None

    def settle(self) -> None:
        if self.pending is not None:
            self.bounds = self.pending()
            self.pending = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return covered_ns([(s, e) for _, s, e in self.ops]) * 1e-9

    def ms_per_tick(self, match=None) -> Optional[float]:
        """Device ms a tick of the ops whose name `match` accepts (all
        ops by default); None with no such op."""
        sel = [(s, e) for n, s, e in self.ops if match is None or match(n)]
        if not sel or not self.ticks:
            return None
        return covered_ns(sel) * 1e-6 / self.ticks

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps, each named by the host span around it."""
        by_name = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = union([(s, e) for _, s, e in self.ops])
        gaps = []
        t = self.window[0]
        for s, e in busy + [[self.window[1], self.window[1]]]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (s + e) // 2
            host = [n for n, a, b in self.spans if a <= mid < b]
            named.append([host[-1] if host else "no benchmark span",
                          (e - s) * 1e-9])
        return dict(device_ops=[[n[:160], ns * 1e-9] for n, ns in top],
                    idle_gaps=named)
