"""webgpu_raytracer_tpu: a progressive path-tracing framework in JAX.

A JAX/XLA/Pallas rebuild of the capabilities of
kokutoupan/webgpu-raytracer (browser WebGPU path tracer): native C++ scene
compiler (OBJ/glTF, animation, skinning, BLAS/TLAS), vectorized stackless
path tracing on an NVIDIA GPU (a Pallas-Triton kernel for the dense sweep,
XLA for the rest), progressive accumulation + TAA post-processing, offline
recording, and distributed multi-device / multi-host rendering.
"""

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_checkout_compile_cache() -> None:
    """Keep JAX's persistent compilation cache in <checkout>/.cache/jax.

    Does nothing when JAX_COMPILATION_CACHE_DIR is set: JAX then uses that
    directory itself. The path is fixed, so a second run finds the first
    run's programs."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(_CHECKOUT, ".cache", "jax"))


use_checkout_compile_cache()

from .config import RenderConfig  # noqa: E402
from .models.native import NativeWorld  # noqa: E402
from .render.renderer import Renderer  # noqa: E402

__all__ = ["RenderConfig", "NativeWorld", "Renderer"]
__version__ = "0.1.0"
