"""Benchmark: Mrays/sec per device across the BASELINE configs.

    python bench.py               # every config
    python bench.py --quick       # the headline only
    python bench.py --kernel-ab   # Renderer frame times, GPU kernel vs XLA
    python bench.py --soak        # 1080p progressive soak + checkpoint

Prints one JSON line per config, each naming the platform, device kind,
device count and the card's power limit; the HEADLINE (BASELINE config 2:
cornell 512x512 depth 8) is printed LAST. Fails when JAX finds no GPU.

Methodology:
- Frames are CHAINED in one jitted lax.fori_loop and reduced to a scalar on
  device, so the wall time contains no per-frame dispatch and only one tiny
  host readback; the time of a short chain is subtracted from a long one.
- Each scene runs on the backend the Renderer would choose for it
  (ops/api.choose_backend).
- Ray counts are EXACT: the tracers count primary + NEE shadow + extension
  lanes actually traced, measured for the same frame sequence that is timed.
- Correctness gating is DEFAULT-ON: each config's mean radiance is asserted
  against its golden value (GOLDENS) and reported as "golden_ok" per metric
  line. A failed golden or a config that raises makes the run exit nonzero
  after all lines print. `--no-check` opts out of the golden gate;
  unrecorded goldens emit "golden_mean" for recording instead.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPEATS = 3  # best-of-N windows

# Golden mean radiance per config: image statistics of oracle-validated
# renders, with ~2% Monte-Carlo tolerance. The gate is DEFAULT-ON: every
# bench run doubles as a correctness check (--no-check to opt out; a None
# value emits the measured mean for recording instead of gating).
GOLDENS = {
    "cornell": 0.3040,
    "cornell_1080p": 0.1766,
    "gem": 0.3751,
    "spheres": 0.0424,
    "textured": 0.2739,
}
GOLDEN_TOL = 0.02

# A gem-like convex OBJ standing in for the reference's bundled diamond.obj
# (an asset we deliberately do not copy): icosahedron, BASELINE config 1.
_PHI = (1 + 5 ** 0.5) / 2
_ICO_V = [(-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0),
          (0, -1, _PHI), (0, 1, _PHI), (0, -1, -_PHI), (0, 1, -_PHI),
          (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1)]
_ICO_F = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
          (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
          (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
          (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
GEM_OBJ = "".join(f"v {x} {y} {z}\n" for x, y, z in _ICO_V) + \
    "".join(f"f {a+1} {b+1} {c+1}\n" for a, b, c in _ICO_F)


def device_fields() -> dict:
    """The device every number ran on; fails when JAX finds no GPU."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's first device is {d}")
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": card}


def build(scene_name, obj_source=None, glb_data=None, width=512, height=512):
    from webgpu_raytracer_tpu.models.native import NativeWorld
    from webgpu_raytracer_tpu.ops.api import choose_backend
    from webgpu_raytracer_tpu.render.resources import build_device_scene
    from webgpu_raytracer_tpu.render.worldtris import (build_world_tris,
                                                       world_tri_count)
    from webgpu_raytracer_tpu.utils.textures import decode_world_textures

    from webgpu_raytracer_tpu.utils.textures import build_quad_pyramid

    world = NativeWorld(scene_name, obj_source, glb_data)
    world.update_camera(width, height)
    # Decode to the 1024^2 texture array like the Renderer does — without
    # this, textured configs silently bench the 1x1 fast path. Like the
    # Renderer, textured scenes carry the quad-table pyramid: level 0 for
    # bounce-0 samples, the secondary mip for bounces >= 1
    # (utils/textures.SECONDARY_MIP).
    dec = decode_world_textures(world)
    scene = build_device_scene(world, textures=dec)
    if dec is not None:
        from webgpu_raytracer_tpu.utils.textures import device_pyramid

        pyr = device_pyramid(build_quad_pyramid(dec))
        scene = scene._replace(
            textures=pyr[0] if pyr[1] is pyr[0] else pyr)
    camera = jnp.asarray(world.camera())
    backend = choose_backend(world_tri_count(world))
    if backend == "dense":
        return world, (build_world_tris(world), scene.textures), camera
    return world, scene, camera


def _backend(scene) -> str:
    return "dense" if isinstance(scene, tuple) else "bvh"


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "spp", "depth",
                                    "backend"))
def _chained_frames(scene, camera, *, width, height, spp, depth, n,
                    backend):
    """n progressive frames chained on device; returns (mean-radiance sum,
    exact total rays traced). `n` is DYNAMIC on purpose: with a static
    bound XLA unrolls the frame loop, and a dynamic bound means one compile
    covers every n."""
    from webgpu_raytracer_tpu.ops.api import get_tracer

    tracer = get_tracer(backend)

    def body(i, acc):
        s, rays = acc
        col, r = tracer(scene, camera, i + 1, jnp.zeros(2, jnp.float32),
                        width, height, spp, depth, with_stats=True)
        return s + col.mean(), rays + r

    return jax.lax.fori_loop(
        0, n, body, (jnp.zeros(()), jnp.zeros(())))


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "spp", "depth",
                                    "backend"))
def _chained_frames_gb(scene, camera, *, width, height, spp, depth, n,
                       backend):
    """Like _chained_frames but with the G-buffer-seeded bounce 0
    (render_step(use_gbuffer=True) semantics, dense backend): rasterize
    primary visibility, seed every sample's first hit from the id channel.
    Radiance is bit-identical to the traced path at lens_radius == 0, so
    the same golden gates both (tests/test_gbuffer_post.py)."""
    from webgpu_raytracer_tpu.ops.dense_trace import trace_pixels_dense
    from webgpu_raytracer_tpu.ops.gbuffer import render_gbuffer

    wt, tex = scene
    jitter = jnp.zeros(2, jnp.float32)

    def body(i, acc):
        s, rays = acc
        gb = render_gbuffer(wt, tex, camera, width, height, jitter=jitter)
        col, r = trace_pixels_dense(
            wt, tex, camera, i + 1, jitter, width, height, spp, depth,
            with_stats=True, seed_wt_idx=gb.wt_idx.reshape(-1))
        return s + col.mean(), rays + r + width * height

    return jax.lax.fori_loop(
        0, n, body, (jnp.zeros(()), jnp.zeros(())))


def measure(scene, camera, width, height, spp, depth, n,
            chained=_chained_frames):
    """MARGINAL chained timing: time(run(n)) - time(run(n/4)) cancels the
    fixed cost of dispatch and readback, so the result is device
    throughput. Returns (Mrays/s, mean radiance, rays per frame)."""
    run = lambda k: chained(scene, camera, width=width, height=height,
                            spp=spp, depth=depth, n=k,
                            backend=_backend(scene))
    n2 = max(1, n // 4)
    s, rays_n = run(n)   # warm (compile) both shapes
    rays_2 = float(np.asarray(run(n2)[1]))
    rays_total = float(np.asarray(rays_n))
    mean_rad = float(np.asarray(s)) / n
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        np.asarray(run(n2)[0])
        t2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.asarray(run(n)[0])
        tn = time.perf_counter() - t0
        best = min(best, max(tn - t2, 1e-6))
    d_rays = rays_total - rays_2
    return d_rays / best / 1e6, mean_rad, rays_total / n


_DEVICE: dict = {}
_errors: list = []


def emit(metric, value, unit, **extra):
    rec = {"metric": metric, "value": value, "unit": unit}
    rec.update(extra)
    rec.update(_DEVICE)
    print(json.dumps(rec), flush=True)


def failed(metric, unit, err):
    """A config that raised: its line says so, and the run exits nonzero
    after every line has printed."""
    _errors.append(f"{metric}: {err!r}")
    emit(metric, None, unit, error=str(err)[:200])


_golden_failures: list = []


def golden_fields(name, mean_rad, check):
    """Per-config golden gate: {"golden_ok": bool} when gating (default), the
    measured mean for recording when the golden is unrecorded or gating is
    off. A failed gate is also collected so main() can exit nonzero AFTER all
    metric lines print (the driver reads the trailing headline line)."""
    golden = GOLDENS.get(name)
    if golden is None or not check:
        return {"golden_mean": round(mean_rad, 4)}
    err = abs(mean_rad - golden) / abs(golden)
    ok = bool(err < GOLDEN_TOL)
    if not ok:
        _golden_failures.append(
            f"{name}: mean {mean_rad:.4f} deviates {err:.1%} "
            f"from golden {golden}")
    return {"golden_ok": ok}


def soak(argv):
    """BASELINE config 5's operating point, one device: a long progressive
    1080p accumulation through the PRODUCT Renderer, checkpointed mid-run
    (render/checkpoint.py) and resumed into a FRESH renderer; asserts the
    resumed accumulation is BIT-IDENTICAL to the uninterrupted run and
    reports accumulated spp/sec. `--soak-spp N` overrides the 1024 target
    (use a small N for a smoke pass)."""
    import os
    import tempfile

    from webgpu_raytracer_tpu.config import RenderConfig
    from webgpu_raytracer_tpu.render.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from webgpu_raytracer_tpu.render.renderer import Renderer

    target = 1024
    if "--soak-spp" in argv:
        target = int(argv[argv.index("--soak-spp") + 1])
    cfg = RenderConfig(width=1920, height=1080, max_depth=8, shader_spp=1)

    r = Renderer("cornell", config=cfg)
    r.render_frame()
    np.asarray(r.accum)  # warm/compile

    # Uninterrupted reference run (timed).
    r2 = Renderer("cornell", config=cfg)
    t0 = time.perf_counter()
    for _ in range(target):
        r2.render_frame()
    ref = np.asarray(r2.accum)
    wall = time.perf_counter() - t0

    # Interrupted run: checkpoint at half, restore into a fresh renderer.
    half = target // 2
    r3 = Renderer("cornell", config=cfg)
    for _ in range(half):
        r3.render_frame()
    ckpt = os.path.join(tempfile.mkdtemp(prefix="wrt_soak"), "ck")
    save_checkpoint(ckpt, r3)
    r4 = Renderer("cornell", config=cfg)
    assert load_checkpoint(ckpt, r4), "checkpoint restore failed"
    for _ in range(target - half):
        r4.render_frame()
    resumed = np.asarray(r4.accum)
    bitexact = bool((ref == resumed).all())

    emit("soak_1080p_progressive_spp_per_sec", target / wall, "spp/s",
         accumulated_spp=target, wall_s=round(wall, 1),
         bitexact_resume=bitexact)
    return 0 if bitexact else 1


def kernel_ab(argv):
    """The measurement behind the dense-sweep kernel decision: median
    Renderer.render_frame time (synced with block_until_ready, after
    warm-up) with the GPU kernel and with the XLA reference sweep, taken in
    turns (kernel, XLA, kernel, XLA) on one card; spheres (the BVH path)
    once, as the baseline of a later traversal kernel."""
    from webgpu_raytracer_tpu.config import RenderConfig
    from webgpu_raytracer_tpu.ops.tune import TuneConfig
    from webgpu_raytracer_tpu.render.renderer import Renderer

    frames = 10
    if "--frames" in argv:
        frames = int(argv[argv.index("--frames") + 1])

    def window(scene, w, h, tune):
        r = Renderer(scene, config=RenderConfig(width=w, height=h,
                                                max_depth=8, shader_spp=1),
                     tune=tune)
        for _ in range(2):  # compile + warm
            jax.block_until_ready(r.render_frame())
        ts = []
        for _ in range(frames):
            t0 = time.perf_counter()
            jax.block_until_ready(r.render_frame())
            ts.append(time.perf_counter() - t0)
        rays = float(np.asarray(r.last_rays))
        return r.backend, float(np.median(ts)) * 1e3, ts, rays

    cells = [("cornell", 512, 512), ("cornell", 1920, 1080),
             ("mixed", 512, 512)]
    for scene, w, h in cells:
        res = {"kernel": [], "xla": []}
        for rnd in range(2):
            for name, tune in (("kernel", TuneConfig()),
                               ("xla", TuneConfig(reference_sweep=True))):
                res[name].append(window(scene, w, h, tune))
        for name, runs in res.items():
            meds = [m for _, m, _, _ in runs]
            emit(f"{scene}_{w}x{h}_d8_frame_ms_{name}_sweep",
                 float(np.median(meds)), "ms",
                 window_medians_ms=meds, frames_per_window=frames,
                 spread_ms=[float(np.min(ts)) * 1e3 for *_, ts, _ in runs]
                 + [float(np.max(ts)) * 1e3 for *_, ts, _ in runs],
                 rays_last_frame=runs[-1][3], backend=runs[-1][0])
    backend, med, ts, rays = window("spheres", 512, 512, TuneConfig())
    emit("spheres_512x512_d8_frame_ms", med, "ms", backend=backend,
         frames_per_window=frames, min_ms=float(np.min(ts)) * 1e3,
         max_ms=float(np.max(ts)) * 1e3, rays_last_frame=rays)
    return 1 if _errors else 0


def main(argv):
    check = "--no-check" not in argv  # correctness gate is DEFAULT-ON
    quick = "--quick" in argv
    _DEVICE.update(device_fields())
    if "--soak" in argv:
        return soak(argv)
    if "--kernel-ab" in argv:
        return kernel_ab(argv)

    # --- config 2 (HEADLINE): cornell 512x512 depth 8 ---
    world, scene, camera = build("cornell")
    n = 8 if quick else 32
    mrays_cornell, mean_rad, rays_pf = measure(scene, camera, 512, 512, 1,
                                               8, n)
    headline_golden = golden_fields("cornell", mean_rad, check)

    if not quick:
        # --- cornell at 1080p (the BASELINE north-star resolution) ---
        metric = "cornell_1080p_d8_mrays_per_sec_per_chip"
        try:
            world.update_camera(1920, 1080)
            cam_hd = jnp.asarray(world.camera())
            v, m, rpf = measure(scene, cam_hd, 1920, 1080, 1, 8, 8)
            emit(metric, v, "Mrays/s", spp_per_sec_1080p=v * 1e6 / rpf,
                 **golden_fields("cornell_1080p", m, check))
            # A/B: G-buffer-seeded bounce 0 (the reference's rasterizer
            # exists purely to make depth 0 cheap — Rasterizer.wgsl:110-173;
            # delta_vs_traced quantifies whether that pays here).
            metric = "cornell_1080p_d8_gbuffer_seeded_mrays_per_sec"
            vg, mg, rpfg = measure(scene, cam_hd, 1920, 1080, 1, 8, 8,
                                   chained=_chained_frames_gb)
            emit(metric, vg, "Mrays/s",
                 delta_vs_traced=(rpf / max(v, 1e-9))
                 / (rpfg / max(vg, 1e-9)) - 1.0,
                 **golden_fields("cornell_1080p", mg, check))
        except Exception as e:
            failed(metric, "Mrays/s", e)

        # --- config 1: gem OBJ on the viewer pedestal, 256x256 d5 ---
        metric = "gem_obj_256_d5_mrays_per_sec_per_chip"
        try:
            _, sc1, cam1 = build("viewer", obj_source=GEM_OBJ, width=256,
                                 height=256)
            v, m, _ = measure(sc1, cam1, 256, 256, 1, 5, 32)
            emit(metric, v, "Mrays/s", **golden_fields("gem", m, check))
            del sc1, cam1
        except Exception as e:
            failed(metric, "Mrays/s", e)

        # --- large scene: spheres preset (257k tris) on the backend the
        # Renderer picks for it (the BVH walk) ---
        metric = "spheres_257k_512_d8_mrays_per_sec_per_chip"
        try:
            _, scs, cams = build("spheres")
            v, m, rpf = measure(scs, cams, 512, 512, 1, 8, 4)
            emit(metric, v, "Mrays/s", backend=_backend(scs),
                 ms_per_frame=rpf / max(v, 1e-9) / 1e3,
                 **golden_fields("spheres", m, check))
            del scs, cams
        except Exception as e:
            failed(metric, "Mrays/s", e)

        # --- config 3: textured GLB at 1080p d8 (texture-array sampling) ---
        metric = "textured_glb_1080p_d8_mrays_per_sec_per_chip"
        try:
            from tests.glb_fixture import textured_quad_glb

            _, sc3, cam3 = build("viewer", glb_data=textured_quad_glb(),
                                 width=1920, height=1080)
            v, m, rpf = measure(sc3, cam3, 1920, 1080, 1, 8, 8)
            emit(metric, v, "Mrays/s", spp_per_sec_1080p=v * 1e6 / rpf,
                 **golden_fields("textured", m, check))
            del sc3, cam3
        except Exception as e:
            failed(metric, "Mrays/s", e)

        # --- config 4: skinned animation, per-frame refit + reset, 512p ---
        import gc

        gc.collect()
        metric = "skinned_refit_512_d8_fps"
        try:
            from tests.glb_fixture import skinned_strip_glb

            from webgpu_raytracer_tpu.render.renderer import Renderer
            from webgpu_raytracer_tpu.config import RenderConfig

            r = Renderer("viewer", glb_data=skinned_strip_glb(),
                         config=RenderConfig(width=512, height=512,
                                             max_depth=8, shader_spp=1))
            r.update_scene(0.0)
            r.render_frame()
            np.asarray(r.accum)  # warm + sync

            # Product-shape animation loop (render/recorder.py,
            # cli.py --animate): the native refit for frame k+1 runs on the
            # WorldBridge worker thread (C++ releases the GIL) while the
            # device renders frame k — the reference overlaps its WASM
            # worker with GPU frames identically (VideoRecorder.ts:183-227).
            def anim_pass(nf, t_base):
                r.bridge.update_async(t_base)
                for k in range(nf):
                    r.bridge.wait()
                    r.reupload_scene()  # refit upload + accumulation reset
                    if k + 1 < nf:
                        r.bridge.update_async(t_base + (k + 1) / 30.0)
                    r.render_frame()
                # Sync on a device-side scalar, not the 4 MB accumulator.
                np.asarray(jnp.sum(r.accum))

            anim_pass(2, 1.0 / 30.0)  # warm the bridge/overlap path
            nf = 24
            fps = 0.0
            for trial in range(2):
                t0 = time.perf_counter()
                anim_pass(nf, (3.0 + trial * nf) / 30.0)
                fps = max(fps, nf / max(time.perf_counter() - t0, 1e-6))
            emit(metric, fps, "frames/s")
        except Exception as e:
            failed(metric, "frames/s", e)

    # headline LAST
    emit("cornell_512_d8_mrays_per_sec_per_chip", mrays_cornell, "Mrays/s",
         **headline_golden)
    if _golden_failures:
        print("GOLDEN CHECK FAILED:\n  " + "\n  ".join(_golden_failures),
              file=sys.stderr, flush=True)
    if _errors:
        print("CONFIGS FAILED:\n  " + "\n  ".join(_errors),
              file=sys.stderr, flush=True)
    return 1 if _golden_failures or _errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
