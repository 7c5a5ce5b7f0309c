"""Renderer facade: pass orchestration, accumulation state, history swap.

The analogue of reference src/renderer/WebGPURenderer.ts: owns the
device-side scene resources, the jitted render step (compute pass), the
post-process step (present), the progressive accumulation buffer, and the TAA
history carry. `build_pipeline(depth, spp)` mirrors the reference's
pipeline-override recompile (RaytracePass.ts:26-32): depth/spp are static jit
arguments, so changing them triggers recompilation.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..models.bridge import WorldBridge
from ..ops.api import choose_backend, get_tracer
from ..ops.postprocess import postprocess
from ..ops.trace import accumulate
from ..ops.tune import DEFAULT_TUNE, TuneConfig
from ..utils.halton import JitterAccumulator, frame_jitter
from .resources import DeviceScene, build_device_scene
from .worldtris import build_world_tris, world_tri_count


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "backend",
                     "use_gbuffer", "tune"),
    donate_argnames=("accum",),
)
def render_step(scene, camera, frame_count, jitter, accum, *,
                width: int, height: int, spp: int, max_depth: int,
                backend: str = "bvh", use_gbuffer: bool = False,
                tune: TuneConfig = DEFAULT_TUNE):
    """One progressive frame: trace + accumulate (WebGPURenderer.compute).

    use_gbuffer=True (dense backend): rasterizer-pass analogue — render the
    primary-visibility G-buffer first and seed every sample's bounce 0 from
    its id channel instead of tracing primaries (the reference pipeline's
    Rasterizer.wgsl -> Raytracer.wgsl:617-654 hand-off). Radiance is
    bit-identical to the traced-primary path at lens_radius == 0
    (tests/test_gbuffer_post.py).

    Returns (accum, rays): `rays` is the EXACT device-side count of rays
    traced this frame (incl. the G-buffer's own primary cast when seeding) —
    the measured Mrays/s numerator for the stats line."""
    kwargs = {"tune": tune} if backend == "dense" else {}
    gb_rays = 0.0
    if use_gbuffer and backend == "dense":
        from ..ops.gbuffer import render_gbuffer

        wt, textures = scene
        gb = render_gbuffer(wt, textures, camera, width, height,
                            jitter=jitter, tune=tune)
        kwargs["seed_wt_idx"] = gb.wt_idx.reshape(-1)
        gb_rays = float(width * height)  # the G-buffer's primary cast
    col, rays = get_tracer(backend)(scene, camera, frame_count, jitter, width,
                                    height, spp, max_depth, with_stats=True,
                                    **kwargs)
    return accumulate(accum, col, frame_count), rays + gb_rays


@functools.partial(jax.jit, static_argnames=("width", "height"))
def present_step(accum, history, frame_count, average_jitter, *, width: int,
                 height: int):
    """Post-process + history swap (WebGPURenderer.present)."""
    acc_img = accum.reshape(height, width, 4)
    ldr, new_history = postprocess(acc_img, history, frame_count, average_jitter)
    return ldr, new_history


class Renderer:
    """End-to-end progressive path tracer over a native World."""

    def __init__(
        self,
        scene_name: str = "cornell",
        obj_source: Optional[str] = None,
        glb_data: Optional[bytes] = None,
        config: Optional[RenderConfig] = None,
        tune: TuneConfig = DEFAULT_TUNE,
    ):
        if config is None:
            config = RenderConfig(scene_name=scene_name)
        elif scene_name != "cornell":
            config.scene_name = scene_name
        self.config = config
        self.tune = tune  # frozen dense-tracer tuning (static jit key)
        scene_name = self.config.scene_name
        self.width = self.config.width
        self.height = self.config.height
        self.max_depth = self.config.max_depth
        self.spp = self.config.shader_spp

        # The native scene compiler lives behind the async bridge so scene
        # updates can overlap device work (reference src/world-bridge.ts).
        self.bridge = WorldBridge(scene_name, obj_source, glb_data)
        self.world = self.bridge.world
        if 0 < self.config.anim_index < self.world.animation_count():
            # Apply the configured clip before the first flatten (reference
            # UIManager anim select -> set_animation, applied remotely at
            # DistributedWorker.ts:190-200).
            self.world.set_animation(self.config.anim_index)
            self.world.update(0.0)
        self.world.update_camera(self.width, self.height)
        from ..utils.textures import build_quad_pyramid, decode_world_textures

        self._textures_np = decode_world_textures(self.world)
        if self._textures_np is not None:
            # Pack ONCE and keep the DEVICE arrays: textures never change
            # across scene ticks, and jnp.asarray of an existing device
            # array is a no-op — so animated re-uploads skip the multi-MB
            # texture transfer entirely. The (level0, mip) pyramid feeds the
            # dense path (bounces >= 1 sample the mip — see
            # ops/dense_trace.tex_level); the BVH path reads level 0.
            from ..utils.textures import device_pyramid

            pyr = device_pyramid(build_quad_pyramid(self._textures_np))
            self._textures_np = pyr[0] if pyr[1] is pyr[0] else pyr
        self.scene: DeviceScene = build_device_scene(
            self.world, textures=self._tex_l0())
        n_world_tris = self._world_tri_count()
        self.backend = choose_backend(n_world_tris)
        self.wt = build_world_tris(self.world) if self.backend == "dense" else None
        self.camera = jnp.asarray(self.world.camera())

        self.frame_count = 0
        self._jitter_acc = JitterAccumulator(self.width, self.height)
        self._alloc_buffers()

    # -- lifecycle ---------------------------------------------------------

    def _tex_l0(self):
        from ..ops.dense_trace import tex_level

        return (tex_level(self._textures_np, 0)
                if self._textures_np is not None else None)

    def _world_tri_count(self) -> int:
        return world_tri_count(self.world)

    def _step_scene(self):
        if self.backend == "dense":
            return (self.wt,
                    self._textures_np if self._textures_np is not None
                    else self.scene.textures)
        return self.scene

    def _alloc_buffers(self):
        R = self.width * self.height
        self.accum = jnp.zeros((R, 4), jnp.float32)
        self.history = jnp.zeros((self.height, self.width, 3), jnp.float32)

    def build_pipeline(self, max_depth: int, spp: int):
        """Static-parameter change -> new jit cache entry (recompile)."""
        self.max_depth = int(max_depth)
        self.spp = int(spp)
        self.reset_accumulation()

    def update_screen_size(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.world.update_camera(self.width, self.height)
        self.camera = jnp.asarray(self.world.camera())
        self._jitter_acc = JitterAccumulator(self.width, self.height)
        self.reset_accumulation()

    def reset_accumulation(self):
        self.frame_count = 0
        self._jitter_acc = JitterAccumulator(self.width, self.height)
        # Accumulator reset is SEMANTIC: accumulate() overwrites (not adds)
        # at frame_count 1 (wgsl:813-818's frame==1 select), so the stale
        # buffer never contributes — no realloc/zero-fill dispatch on the
        # animated per-tick path. The TAA history does feed frame 1
        # (alpha=0.1 blend, PostProcess.wgsl:136-167) and must clear.
        if self.accum.shape != (self.width * self.height, 4):
            self._alloc_buffers()
        else:
            self.history = jnp.zeros_like(self.history)

    # -- scene updates -----------------------------------------------------

    def update_scene(self, time: float, reset: bool = True):
        """Tick the native scene compiler and re-upload flat buffers."""
        self.world.update(time)
        self.reupload_scene(reset=reset)

    def set_animation(self, index: int, time: float = 0.0):
        """Select the active animation clip and re-flatten the scene
        (reference src/ui/UIManager.ts anim select -> World.set_animation)."""
        self.world.set_animation(int(index))
        self.config.anim_index = int(index)
        self.update_scene(time)

    def load_animation_glb(self, data: bytes) -> bool:
        """Merge animation clips from another GLB (World.load_animation_glb,
        reference rust-shader-tools/src/lib.rs:120-147)."""
        return self.world.load_animation_glb(data)

    def reupload_scene(self, reset: bool = True):
        """Re-upload device tables from the (already updated) native world —
        the upload half of update_scene, used by the recorder's host/device
        overlap (the world update runs on a worker thread meanwhile).

        The dense backend's render step reads only (wt, textures), so the
        BVH-path DeviceScene rebuild (TLAS/BLAS absolutization + ~10 device
        uploads) is skipped there — it was pure per-tick overhead on the
        animation hot path."""
        self.world.update_camera(self.width, self.height)
        if self.backend == "dense":
            # Camera rides the packed scene transfer: one device_put per
            # tick instead of two.
            cam = np.asarray(self.world.camera(), np.float32)
            self.wt, ex = build_world_tris(self.world,
                                           extra={"camera24": cam})
            self.camera = ex["camera24"]
        else:
            self.scene = build_device_scene(self.world,
                                            textures=self._tex_l0())
            self.camera = jnp.asarray(self.world.camera())
        if reset:
            self.reset_accumulation()

    # -- per-frame ---------------------------------------------------------

    def render_frame(self, use_gbuffer: bool = False):
        """Trace one progressive frame into the accumulator.

        use_gbuffer=True seeds bounce 0 from the rasterizer-analogue
        G-buffer pass (dense backend only; see render_step).

        Sets self.last_rays (device scalar, unread until needed) with the
        exact ray count of this frame for measured-Mrays/s reporting."""
        self.frame_count += 1
        jitter, self._avg_jitter = self._jitter_acc.step(self.frame_count)
        self.accum, self.last_rays = render_step(
            self._step_scene(),
            self.camera,
            jnp.asarray(self.frame_count, jnp.int32),
            jnp.asarray(jitter),
            self.accum,
            width=self.width,
            height=self.height,
            spp=self.spp,
            max_depth=self.max_depth,
            backend=self.backend,
            use_gbuffer=use_gbuffer and self.backend == "dense",
            tune=self.tune,
        )
        return self.accum

    def present(self) -> np.ndarray:
        """Run the post-process chain; returns (H, W, 3) uint8.

        Call once per rendered frame (the reference presents every rAF tick):
        the TAA history blend uses alpha = 1/frame_count, which converges to
        the accumulated mean only when the history is advanced every frame.
        A single present over a cold history after many frames will be dark.
        """
        ldr, self.history = present_step(
            self.accum,
            self.history,
            jnp.asarray(self.frame_count, jnp.int32),
            jnp.asarray(getattr(self, "_avg_jitter", np.zeros(2, np.float32))),
            width=self.width,
            height=self.height,
        )
        self._last_frame = np.asarray(ldr)
        return self._last_frame

    def capture_frame(self) -> np.ndarray:
        """Last presented LDR image (WebGPUContext.captureFrame analogue)."""
        if not hasattr(self, "_last_frame"):
            return self.present()
        return self._last_frame

    def radiance(self) -> np.ndarray:
        """Mean HDR radiance of the accumulator, (H, W, 3) float32."""
        acc = np.asarray(self.accum).reshape(self.height, self.width, 4)
        a = np.maximum(acc[..., 3:4], 1e-20)
        return acc[..., 0:3] / a
