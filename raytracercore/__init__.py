"""raytracercore — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference CPU path tracer (Zaggy1024/RaytracerCore): progressive
unidirectional path tracing with per-primitive materials (emission, diffuse,
specular, transmission + IOR, shininess), exact Fresnel with total internal
reflection, triangle/mirrored-quad, sphere/ellipsoid and plane primitives,
BVH acceleration — rebuilt as a batched, differentiable wavefront over SoA
scene arrays, sharded across device meshes.

Layering (bottom-up):
  core/      batched math, RNG, color/tonemap
  scene/     text-format loader → SoA scene arrays
  intersect/ jnp intersection kernels, closest-hit dispatch, megakernel
             row bodies
  bvh/       host SAH builder + flattened-array traversal
  render/    wavefront integrator, film accumulation, progressive renderer
  parallel/  device meshes, shard_map'd render/grad steps
  tools/     debug raycaster, bounce traces, CLI, image IO
"""

__version__ = "0.1.0"

import jax as _jax

# Every matmul/einsum in this package is geometry (sphere/ellipsoid ray
# transforms) or an exact one-hot row gather — never a tolerance-friendly
# NN contraction.  Without this, a float32 matmul on the GPU may run in
# TF32, which keeps about three decimal digits and rounds gathered values
# near 1e-3 relative.  Default the whole package to full-f32 matmuls; hot
# sites additionally pin precision explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import core, scene  # noqa: F401
