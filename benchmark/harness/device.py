"""The card: the look for one, what a run reports of it, and its trace.

A traced window is recorded by `torch.profiler` with the CUDA activity
alone (CUPTI's record of the device's operations): no host operation is
recorded, so a traced window runs as an untraced one does, and its events
are read in memory, so nothing is written to disk. Two marker launches
bound the window on the device's timeline. The trace gives the device's
busy time (the union of its kernel, copy and set intervals), the kernels
that took the most time, and the longest idle gaps, each named by the
driver's phase it falls in: the phases are pairs of CUDA events, placed on
the trace's clock by their time from the first marker.
"""

from __future__ import annotations

import subprocess
import sys

NAME_CHARS = 160  # of a device operation's name in the breakdown


def require_cards(count: int):
    """Exit non-zero, with no result, without `count` CUDA cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {count} CUDA card(s), found {found}; no result",
              file=sys.stderr)
        sys.exit(1)


def card_label() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi unread"


def device_record(count: int) -> dict:
    """The result's `device`: platform, the card's name, cards used and the
    peak of allocated memory on the fullest of them."""
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


class Trace:
    """What a profiled window gives: device intervals, host spans, and the
    window's bounds (ns on the profiler's clock)."""

    def __init__(self, kernels, copies, spans, start_ns, end_ns):
        self.kernels = kernels  # [(name, start_ns, end_ns)] device kernels
        self.copies = copies  # [(name, start_ns, end_ns)] device copies and sets
        self.spans = spans  # [(name, start_ns, end_ns)] the driver's phases
        self.start_ns, self.end_ns = start_ns, end_ns

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_intervals(self):
        """The union of the device's intervals, clipped to the window."""
        ivs = sorted((max(s, self.start_ns), min(e, self.end_ns))
                     for _, s, e in self.kernels + self.copies)
        merged = []
        for s, e in ivs:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, kernel: str):
        """(total seconds, count) of the kernels whose name holds `kernel`."""
        hits = [e - s for n, s, e in self.kernels if kernel in n]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, n: int = 10):
        """The `n` device operations that took the most time, their names
        cut to `NAME_CHARS` (a kernel's full C++ signature says no more)."""
        totals = {}
        for name, s, e in self.kernels + self.copies:
            name = name[:NAME_CHARS]
            totals[name] = totals.get(name, 0) + (e - s)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10):
        """The longest idle gaps of the window, each named by the driver's
        phase that holds its start (`host` where none does)."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            name = next((sn for sn, a, b in self.spans if a <= s < b), "host")
            out.append([name, (e - s) * 1e-9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


class Profiler:
    """`torch.profiler` over a window, the device's operations alone:
    `start()`, `stop()`, then `read()`."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._flag = torch.zeros(1, device="cuda")
        self._origin = torch.cuda.Event(enable_timing=True)

    def start(self):
        self._torch.cuda.synchronize()
        self._prof.__enter__()
        self._flag.fill_(1.0)  # the window's first device operation
        self._origin.record()

    def stop(self):
        self._torch.cuda.synchronize()
        self._flag.fill_(2.0)  # its last
        self._torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def read(self, phases=()) -> Trace:
        """The stopped window's `Trace` (read after the measured window:
        reading the events takes seconds of host time). `phases` are
        (name, start event, end event), CUDA events recorded in the window."""
        device_type = self._torch.autograd.DeviceType
        kernels, copies = [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != device_type.CUDA or e.is_user_annotation():
                continue
            s = e.start_ns()
            iv = (e.name(), s, s + e.duration_ns())
            low = iv[0].lower()
            (copies if ("memcpy" in low or "memset" in low) else kernels).append(iv)
        if not kernels + copies:
            raise RuntimeError("the profiler recorded no device operation in the traced window")
        first = min(kernels + copies, key=lambda iv: iv[1])
        start, end = first[1], max(iv[2] for iv in kernels + copies)
        spans = [(name, first[2] + round(self._origin.elapsed_time(a) * 1e6),
                  first[2] + round(self._origin.elapsed_time(b) * 1e6)) for name, a, b in phases]
        return Trace(kernels, copies, spans, start, end)
