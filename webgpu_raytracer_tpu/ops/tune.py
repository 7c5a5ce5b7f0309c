"""Frozen tuning parameters for the dense tracer's bounce loop.

Every knob of the hot path lives here as a field of one hashable, immutable
``TuneConfig``. The config is threaded EXPLICITLY from the public tracer
entry points (ops.dense_trace.trace_pixels_dense, render.renderer.render_step)
down to the sweeps, so:

- jit caches key on it visibly (it rides static closures / static_argnames,
  never module globals read at trace time);
- tests and benchmarks construct their own ``TuneConfig`` instead of
  monkeypatching module attributes.

The bounce-loop defaults below were chosen on the accelerator the project
first ran on and have not been swept on a GPU yet. The field comments say
what each knob trades.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class TuneConfig(NamedTuple):
    # Tail-compaction schedule ((depth, div), ...): from bounce `depth`
    # onward live lanes run in a static ceil(R/div) buffer. Depths ascend;
    # budgets are relative to the ORIGINAL R.
    tail_stages: Tuple[Tuple[int, int], ...] = ((5, 16),)
    # Schedule for scenes of more than one 128-triangle chunk: open scenes
    # lose most lanes to escape by bounce 2, so an early stage pays there,
    # while closed single-chunk scenes overflow it and pay its cond.
    tail_stages_multitile: Tuple[Tuple[int, int], ...] = ((2, 4), (5, 16))
    # Round tail budgets up to kernel-tile-friendly multiples.
    tail_align: int = 2048
    # No tail compaction below this lane count (small frames are
    # launch-bound; compaction overhead loses).
    tail_min_r: int = 100000
    # Strip-mining: lanes per band at large R.
    band_target: int = 140000
    # Frames at or below this lane count run unbanded.
    band_min_r: int = 1 << 19
    # "auto": COLUMN bands for landscape frames (dead periphery collapses
    # into all-dead bands), row bands otherwise; "rows"/"cols" force.
    band_axis: str = "auto"
    # True runs the plain XLA sweep (ops/dense.py) on every platform instead
    # of the GPU kernel: the reference that the kernel is compared and timed
    # against (chip_smoke.py, bench.py). Never set on the product path.
    reference_sweep: bool = False


DEFAULT_TUNE = TuneConfig()
