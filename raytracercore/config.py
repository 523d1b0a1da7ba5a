"""Central runtime configuration.

The reference's "config system" is compile-time defines scattered across
files (``#define BVH`` Scene.cs:1, ``HIT_STRUCT`` Hit.cs:1, SIMD feature
booleans Vec4D.cs:20-26 — SURVEY §5.6/§2.8).  Here every tunable lives in one
module, and one function, :func:`trace_route`, decides which implementation
runs a bounce loop.
"""

from __future__ import annotations

import functools
import logging
import os
import pathlib

import jax
import jax.numpy as jnp

log = logging.getLogger(__name__)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENES_DIR = REPO_ROOT / "scenes"

# Megakernel triangle test: keep the scalar path's coplanar ray-in-plane
# branch (Triangle.cs:161-171)?  False matches the reference's own
# production tier — its AVX path (RayTraceAVXFaster, Triangle.cs:107-125,
# active whenever AVX2+FMA exist, i.e. on the benchmark machine) has no
# coplanar branch.  det == 0 has measure zero under jittered camera rays;
# the XLA integrator keeps the exact scalar semantics, and chip_smoke.py's
# kernel-vs-XLA classification guards the difference on the card.
FUSED_COPLANAR_BRANCH = False

# Renderer(accelerator="auto") builds a BVH once the scene has more
# triangles than this.  Below it every ray tests every row: in the
# megakernel on the GPU, in XLA's fused [rays x prims] scan elsewhere.  On
# the card the megakernel still beat the BVH walk at 32768 triangles
# (PERF.md); the crossover lies above it.
BVH_AUTO_THRESHOLD = 32768

# Triangles per BVH leaf for the XLA walk (bvh/traverse.py): the fastest
# of the leaf-width sweep on the card (PERF.md).
BVH_LEAF_SIZE = 4

@functools.cache
def _log_fallback(reason: str) -> None:
    log.warning("megakernel not used (%s); running the XLA integrator",
                reason)


def trace_route(scene, dtype) -> str:
    """The implementation of the whole forward bounce loop of ``scene``
    with rays of ``dtype`` — the progressive render pass and the train
    step's recording pass: ``"triton"`` (the megakernel,
    :mod:`.render.fused`) or ``"xla"`` (the integrator,
    :func:`.render.integrator.trace`).

    The megakernel beat the integrator end to end on the card in both uses
    (PERF.md).  It runs only on a GPU, and only for scenes it implements in
    float32.  When a GPU run falls back to XLA for the scene or the dtype,
    the reason is logged once.
    """
    if jax.default_backend() != "gpu":
        return "xla"
    if scene.debug_geom:
        reason = "the scene uses the 'debug geom' view"
    elif jnp.dtype(dtype) != jnp.float32:
        reason = f"rays are {jnp.dtype(dtype).name}, the kernel is float32"
    else:
        return "triton"
    _log_fallback(reason)
    return "xla"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself).  Otherwise the cache lives at ``<repo>/.jax_cache``: a fixed
    path, since the directory is part of what a cache hit matches on.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(REPO_ROOT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
