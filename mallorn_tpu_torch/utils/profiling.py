"""Tracing and timing (port of ``mallorn_tpu.utils.profiling``).

- ``Timings``: scoped wall-clock sections with a collected report;
- ``device_trace(log_dir)``: a ``torch.profiler`` scope over the CPU and,
  when a card is present, its CUDA kernels, exported as a Chrome trace
  (``chrome://tracing`` or Perfetto); nothing when ``log_dir`` is None;
- ``block_and_time``: a call's seconds, the card synchronised when the
  result lies on it.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch


class Timings:
    """Hierarchical wall-clock section timer."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []
        self._stack: List[str] = []

    @contextlib.contextmanager
    def section(self, name: str):
        self._stack.append(name)
        label = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((label, time.perf_counter() - t0))
            self._stack.pop()

    def report(self) -> str:
        lines = []
        for label, dt in self.records:
            depth = label.count("/")
            lines.append(f"{'  ' * depth}{label.split('/')[-1]:<40s} {dt:8.2f}s")
        return "\n".join(lines)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for label, dt in self.records:
            out[label] = out.get(label, 0.0) + dt
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the scope and write ``trace_<pid>_<ns>.json`` (Chrome trace
    format) under ``log_dir``; yields the profiler (None when ``log_dir``
    is None, which traces nothing)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _cuda_devices(x, found: set) -> set:
    if torch.is_tensor(x):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


def block_and_time(fn, *args, **kwargs):
    """Run ``fn``, wait for its CUDA results, return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
