"""Proof that the path tracer runs on an NVIDIA GPU, end to end.

    python3 chip_smoke.py           # one card: phases 1-3
    python3 chip_smoke.py --multi   # four cards: the sharded render only

Phases (one process; any failure exits non-zero and prints no result):

1. Device: JAX's first device must be a GPU. The script never falls back
   to the CPU.
2. Kernel: the dense sweep kernel (ops/sweep.py), compiled for the card, is
   compared with the XLA reference (ops/dense.py, Precision.HIGHEST) on the
   card at 262,144 camera and random rays, on `cornell` (one triangle
   tile) and `mixed` (4,360 triangles): closest hit with shade rows, any
   hit, and the fused 2R shadow+extension call. Tolerances are those of
   tests/sweep_checks.py.
3. Render, through the entry points a user calls: `cli render` of cornell
   1920x1080 depth 8 writes a PNG; `Renderer` renders cornell 512^2 and
   1920x1080, mixed 512^2 and spheres 512^2 (257k triangles: the BVH path),
   all depth 8. Mean radiance is held to the goldens of bench.py within
   GOLDEN_TOL; mixed, which has no golden, is held to the render of the
   same frames with the XLA reference sweep.

--multi (four cards): the tile-sharded and tile x sample (2x2) steps of
parallel/sharding.py render cornell on the dense backend and are compared
with the single-card render_step: bit-exact at 512^2, where both run one
band per device; at 1920x1080, where the band layouts differ, >= 99% of
pixels within rtol 1e-5 / atol 1e-6 and a mean absolute difference below
1e-4 (the tolerance of tests/test_dense.py's column-banding test).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
FRAMES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[{self.name}] start")
        return self

    def __exit__(self, kind, value, tb):
        dt = time.perf_counter() - self.t0
        log(f"[{self.name}] {'ok' if kind is None else 'FAILED'} "
            f"in {dt:.1f} s")
        return False


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {devs[0]}")
    log(f"[device] {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    log(f"[device] card: {card_line()}")
    return devs


def phase_kernel():
    import numpy as np

    from webgpu_raytracer_tpu.models.native import NativeWorld
    from webgpu_raytracer_tpu.render.worldtris import build_world_tris
    from tests.sweep_checks import camera_rays, compare, random_rays

    failed = []
    for scene in ("cornell", "mixed"):
        world = NativeWorld(scene)
        world.update_camera(512, 512)
        wt = build_world_tris(world)
        ro, rd = camera_rays(world, 512, 512)
        lane = np.arange(ro.shape[0])
        # every 5th camera ray bounded halfway to the focal plane, every
        # 7th inactive: the same mix random_rays gives
        cam = (ro, rd, np.where(lane % 5 == 0, 0.5, 1e30).astype(np.float32),
               lane % 7 != 0)
        for kind, (ro_, rd_, t_max, act) in (
                ("camera", cam),
                ("random", random_rays(wt, ro.shape[0], seed=7))):
            for mode in ("closest", "any_hit", "fused"):
                rep = compare(wt, ro_, rd_, t_max, act, mode,
                              interpret=False)
                log(f"[kernel] {scene} tris={int(wt.valid_count)} {kind} "
                    f"{mode}: {json.dumps(rep)}")
                if not rep["ok"]:
                    failed.append(f"{scene}/{kind}/{mode}")
    if failed:
        raise AssertionError(f"kernel disagrees with the reference: {failed}")


def _mean_radiance(r) -> float:
    import numpy as np

    return float(np.asarray(r.radiance(), np.float64).mean())


def _render(scene, width, height, frames=FRAMES, **kw):
    import numpy as np

    from webgpu_raytracer_tpu import RenderConfig, Renderer

    r = Renderer(scene, config=RenderConfig(width=width, height=height,
                                            max_depth=8, shader_spp=1), **kw)
    t0 = time.perf_counter()
    for _ in range(frames):
        r.render_frame()
    np.asarray(r.accum)
    return r, time.perf_counter() - t0


def phase_render():
    import numpy as np

    from bench import GOLDEN_TOL, GOLDENS
    from webgpu_raytracer_tpu import cli
    from webgpu_raytracer_tpu.ops.tune import TuneConfig
    from webgpu_raytracer_tpu.utils.png import decode_png

    failed = []

    def golden(name, r, wall):
        m = _mean_radiance(r)
        err = abs(m - GOLDENS[name]) / GOLDENS[name]
        ok = err < GOLDEN_TOL and np.isfinite(np.asarray(r.accum)).all()
        log(f"[render] {name} {r.width}x{r.height} d{r.max_depth} "
            f"backend={r.backend} frames={r.frame_count} "
            f"wall={wall:.2f}s mean={m:.5f} golden={GOLDENS[name]} "
            f"err={err:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)

    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "smoke_cornell_1080p.png")
    t0 = time.perf_counter()
    cli.main(["render", "--scene", "cornell", "--width", "1920", "--height",
              "1080", "--depth", "8", "--frames", str(FRAMES), "--output",
              png])
    with open(png, "rb") as f:
        img = decode_png(f.read())
    ok = img.shape == (1080, 1920, 3) and 5 < img.mean() < 250
    log(f"[render] cli cornell 1920x1080 d8 -> {png} shape={img.shape} "
        f"mean_pixel={img.mean():.2f} wall={time.perf_counter() - t0:.2f}s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("cli")

    golden("cornell_1080p", *_render("cornell", 1920, 1080))
    golden("cornell", *_render("cornell", 512, 512))

    rk, wk = _render("mixed", 512, 512)
    rx, wx = _render("mixed", 512, 512,
                     tune=TuneConfig(reference_sweep=True))
    a = np.asarray(rk.radiance(), np.float64)
    b = np.asarray(rx.radiance(), np.float64)
    mean_rel = abs(a.mean() - b.mean()) / b.mean()
    agree = (np.abs(a - b) <= 1e-5).all(axis=-1).mean()
    ok = mean_rel < 1e-4 and agree >= 0.999 and np.isfinite(a).all()
    log(f"[render] mixed 512x512 d8 kernel vs XLA sweep, same {FRAMES} "
        f"frames: mean {a.mean():.6f} vs {b.mean():.6f} rel={mean_rel:.2e} "
        f"pixels_within_1e-5={agree:.5f} wall kernel={wk:.2f}s "
        f"xla={wx:.2f}s {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("mixed")

    golden("spheres", *_render("spheres", 512, 512, frames=4))
    if failed:
        raise AssertionError(f"render checks failed: {failed}")


def phase_multi(devs, sizes=((512, 512), (1920, 1080))):
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from webgpu_raytracer_tpu.models.native import NativeWorld
    from webgpu_raytracer_tpu.parallel.sharding import (
        make_mesh, tile_sample_sharded_step, tile_sharded_step)
    from webgpu_raytracer_tpu.render.renderer import render_step
    from webgpu_raytracer_tpu.render.resources import build_device_scene
    from webgpu_raytracer_tpu.render.worldtris import build_world_tris

    if len(devs) != 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX sees {len(devs)}")
    failed = []
    exact_size, tolerant_size = sizes
    for width, height in sizes:
        world = NativeWorld("cornell")
        world.update_camera(width, height)
        scene = (build_world_tris(world), build_device_scene(world).textures)
        camera = jnp.asarray(world.camera())
        frame = jnp.asarray(1, jnp.int32)
        jitter = jnp.zeros(2, jnp.float32)
        R = width * height

        def single(spp):
            acc, _ = render_step(scene, camera, frame, jitter,
                                 jnp.zeros((R, 4), jnp.float32), width=width,
                                 height=height, spp=spp, max_depth=8,
                                 backend="dense")
            assert acc.devices() == {devs[0]}
            return np.asarray(acc)

        def check_layout(out, mesh_devices):
            shard_devs = [s.device for s in out.addressable_shards]
            owners = {d for d in shard_devs}
            ok = owners == set(mesh_devices) and len(owners) == 4
            log(f"[multi] shards on devices "
                f"{sorted(d.id for d in shard_devs)}: "
                f"{'ok' if ok else 'FAIL'}")
            return ok

        def compare(name, out, ref, exact):
            if exact:
                ok = np.array_equal(out, ref)
                stat = f"bit_exact={ok}"
            else:
                close = np.isclose(out, ref, rtol=1e-5,
                                   atol=1e-6).all(axis=1).mean()
                mad = float(np.abs(out - ref).mean())
                ok = close >= 0.99 and mad < 1e-4
                stat = f"pixels_close={close:.5f} mean_abs_diff={mad:.2e}"
            ok = ok and np.isfinite(out).all()
            log(f"[multi] cornell {width}x{height} d8 {name} vs single card: "
                f"{stat} mean={out[:, :3].mean():.5f} "
                f"{'ok' if ok else 'FAIL'}")
            return ok

        t0 = time.perf_counter()
        ref1 = single(1)
        log(f"[multi] single card {width}x{height}: "
            f"{time.perf_counter() - t0:.1f}s")
        tile = tile_sharded_step(make_mesh(devs), width, height, 1,
                                 max_depth=8, backend="dense")
        t0 = time.perf_counter()
        out = tile(scene, camera, frame, jitter, jnp.zeros((R, 4)))
        out.block_until_ready()
        log(f"[multi] tile step {width}x{height}: "
            f"{time.perf_counter() - t0:.1f}s")
        ok = check_layout(out, devs)
        ok = compare("tile", np.asarray(out), ref1,
                     exact=(width, height) == exact_size) and ok
        if not ok:
            failed.append(f"tile {width}x{height}")
        if (width, height) != tolerant_size:
            continue
        ref2 = single(2)
        mesh = Mesh(np.array(devs).reshape(2, 2), ("tile", "sample"))
        grid = tile_sample_sharded_step(mesh, width, height, 2, max_depth=8,
                                        backend="dense")
        t0 = time.perf_counter()
        out = grid(scene, camera, frame, jitter, jnp.zeros((R, 4)))
        out.block_until_ready()
        log(f"[multi] tile x sample step {width}x{height}: "
            f"{time.perf_counter() - t0:.1f}s")
        ok = check_layout(out, devs)
        ok = compare("tile x sample (2x2)", np.asarray(out), ref2,
                     exact=False) and ok
        if not ok:
            failed.append(f"tile x sample {width}x{height}")
    if failed:
        raise AssertionError(f"sharded renders disagree: {failed}")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded render and the single-"
                         "card render it is compared with, nothing else")
    args = ap.parse_args(argv)
    try:
        with Phase("device"):
            devs = phase_device()
        if args.multi:
            with Phase("multi"):
                phase_multi(devs)
        else:
            with Phase("kernel"):
                phase_kernel()
            with Phase("render"):
                phase_render()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    d = devs[0]
    log(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
