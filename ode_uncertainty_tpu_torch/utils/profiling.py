"""Phase timers, a benchmark helper and a device trace (port of
``ode_uncertainty_tpu/utils/profiling.py``).

CUDA launches return before the device finishes, so every timer here waits
for the card (``torch.cuda.synchronize``) before it reads the clock when the
work is on the card. ``device_trace`` records a ``torch.profiler`` trace
(CPU, and CUDA where there is a card) as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch


def _sync(obj) -> None:
    """Waits for the card if ``obj`` (a tensor, or a container of them) or,
    for ``obj`` True, anything is on it."""
    if obj is True:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    tensors = obj if isinstance(obj, (list, tuple)) else (obj,)
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase (device-synchronized
    on the ``sync`` tensors)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name:30s} {self.totals[name]:10.3f}s / {self.counts[name]:5d} calls "
            f"({self.totals[name] / self.counts[name] * 1e3:9.2f} ms each)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block, written to
    ``<log_dir>/trace.json`` (open in chrome://tracing or Perfetto); yields
    the profiler (``key_averages()`` for sums by operation)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync(True)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def benchmark(fn: Callable, *args, reps: int = 10, warmup: int = 1):
    """Returns ``(first_call_s, steady_state_s_per_call)``; the first call
    carries any build or first-use cost (a kernel build, allocator growth)."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    first_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return first_s, (time.perf_counter() - t0) / reps
