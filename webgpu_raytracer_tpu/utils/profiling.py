"""Tracing / profiling helpers.

The reference's observability is a 1 Hz fps/ms overlay + console logs
(SURVEY.md §5.1); this framework adds real per-pass timing, rays/sec
accounting, and jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class FrameStats:
    """Running render statistics (the stats-overlay analogue).

    Ray counts are EXACT: record() takes the per-frame traced-ray count the
    render step returns (Renderer.last_rays — primary + NEE shadow +
    extension lanes actually swept), so rays_per_sec is measured, not
    modeled."""

    width: int
    height: int
    spp: int
    max_depth: int
    frame_times_ms: List[float] = field(default_factory=list)
    frame_rays: List[float] = field(default_factory=list)
    window: int = 60

    def record(self, dt_s: float, rays: float = 0.0):
        self.frame_times_ms.append(dt_s * 1000.0)
        self.frame_rays.append(float(rays))
        if len(self.frame_times_ms) > self.window:
            self.frame_times_ms.pop(0)
            self.frame_rays.pop(0)

    @property
    def ms(self) -> float:
        return float(np.mean(self.frame_times_ms)) if self.frame_times_ms else 0.0

    @property
    def fps(self) -> float:
        return 1000.0 / self.ms if self.ms > 0 else 0.0

    def rays_per_sec(self) -> float:
        """Measured rays/sec over the window (exact counts / wall time)."""
        wall_s = float(np.sum(self.frame_times_ms)) / 1000.0
        if wall_s <= 0:
            return 0.0
        return float(np.sum(self.frame_rays)) / wall_s

    def line(self) -> str:
        return (f"fps={self.fps:.1f} ms={self.ms:.1f} "
                f"{self.rays_per_sec() / 1e6:.1f} Mrays/s")


class PassTimer:
    """Named wall-clock sections with device sync, for coarse pass timing."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            np.asarray(sync_value)  # force device completion
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name}: {total * 1000 / max(n, 1):.2f} ms avg "
                         f"({n} calls, {total:.3f}s total)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/wrt_trace"):
    """jax.profiler trace capture around a block (view with tensorboard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
