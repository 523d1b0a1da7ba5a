"""Path-replay backward: a fast custom gradient path for training.

Generic reverse-AD over the full bounce loop is far slower than the forward
pass: each rematerialized bounce re-runs closest-hit SELECTION (the
[rays × prims] scan or the BVH traversal) and reverse-differentiates through
the whole body.

But the gradient only needs a tiny tape.  Branch selection is discrete and
already stop-gradded (see :mod:`..intersect.dispatch`), and GEOMETRY is
stop-gradded too (geometry gradients are out of scope per SURVEY §7) — so
given the per-bounce decisions (winning primitive, interaction branch,
inside/Fresnel-live flags — everything ``Raytracer.GetColor`` decides by
comparison, Raytracer.cs:65-246) plus the hit NORMAL, the pixel color is a
closed-form differentiable function of the material table: a product of
gathered albedos × ``max(totalLum, 1)`` factors ending in an emission term,
with Fresnel/shininess/IOR entering through [R]-shaped per-ray math.

So the train path is:

1. **Record** (stop-grad): one plain forward pass — any closest-hit
   implementation, including the Triton megakernel or the BVH — that emits
   a :class:`..render.integrator.PathTape` (per-bounce prim + flags + hit
   normal).
2. **Replay** (differentiable): re-walk the recorded path with SHADING MATH
   ONLY.  No selection, no winner re-evaluation, no [rays × prims]
   anything; reverse-AD sees a shallow chain of one material gather and
   elementwise ops per bounce.

Layout: the replay is column-oriented — every quantity is an [R] plane
(vm.*3 tuple math), never [R, 3] — so every elementwise op reads contiguous
rays.  The material gather emits [R] component planes directly.

``grad(trace_replay)`` equals ``grad(trace)`` for the same key (both
differentiate the same fixed-decision estimator; the recorded normal is a
value ``trace`` treats as stop-grad anyway) — which the tests pin.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..core.color import LUM_B, LUM_G, LUM_R
from ..intersect.dispatch import closest_hit
from ..scene.types import SceneArrays
from .integrator import (ONEHOT_MAX_ROWS, BounceType, PathTape,
                         _material_matrix, prepare_uniforms, trace)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _allreduce_in_bwd(x, axis_name):
    """Identity forward; cross-device psum of the COTANGENT in backward.

    Inserted once per bounce on the material matrix inside
    :func:`replay`'s loop body, this turns the material-gradient
    all-reduce into per-bounce buckets issued INSIDE the backward unroll
    (SURVEY §7.6): each rematerialized bounce's transposed-gather gradient
    is psum'd as soon as it exists, so the collectives overlap the
    remaining backward compute instead of queueing as one fused reduction
    at step end.  psum is linear, so bucket-then-add equals add-then-psum
    exactly up to summation order.
    """
    return x


def _allreduce_fwd(x, axis_name):
    return x, None


def _allreduce_bwd(axis_name, _res, ct):
    return (jax.lax.psum(ct, axis_name),)


_allreduce_in_bwd.defvjp(_allreduce_fwd, _allreduce_bwd)


def replay(scene: SceneArrays, ray_o, ray_d, uniforms, tape: PathTape,
           remat: bool = True, grad_axis: str | None = None):
    """Differentiable re-walk of a recorded path.

    Same (color, miss) contract and shading semantics as
    :func:`..render.integrator.trace`, but every discrete decision and every
    geometric quantity comes from ``tape`` instead of intersection, so the
    whole function is [R]-planes of shading math.

    ``remat``: rematerialize each bounce in the backward (checkpoint).  Off,
    reverse-AD saves every bounce's intermediates — more HBM, no recompute.

    ``grad_axis``: name of a shard_map mesh axis carrying ray shards.  When
    set, each bounce's material-gradient contribution is all-reduced
    inside the backward unroll (:func:`_allreduce_in_bwd` — the bucketed,
    overlapped schedule of SURVEY §7.6) and the returned gradients are
    already globally summed.
    """
    R = ray_o.shape[0]
    dtype = ray_o.dtype
    recursion = scene.recursion
    ambient = tuple(scene.ambient_rgb.astype(dtype))
    air = scene.air_refractive_index.astype(dtype)

    # [C, N] so the one-hot gather ([C, N] @ [N, R]) emits component planes.
    matm_T = _material_matrix(scene.materials).T.astype(dtype)
    n = matm_T.shape[1]
    row_ids = jnp.arange(n, dtype=jnp.int32)

    def body(i, carry):
        d, tint, result, miss = carry
        # Per-bounce gradient bucket (no-op forward; psum of this bounce's
        # material cotangent in the backward).
        matm_T_b = (_allreduce_in_bwd(matm_T, grad_axis)
                    if grad_axis is not None else matm_T)

        # Periodic renormalization — must match trace (Raytracer.cs:74-75),
        # including its divide (a/len, not a·rsqrt).
        len_d = jnp.sqrt(vm.dot3(d, d))
        d = vm.where3(i % 3 == 0,
                      (d[0] / len_d, d[1] / len_d, d[2] / len_d), d)

        prim = tape.prim[i]
        flags = tape.flags[i]
        code = flags & PathTape.CODE_MASK
        inside = (flags & PathTape.FLAG_INSIDE) != 0
        f_live = (flags & PathTape.FLAG_FLIVE) != 0
        normal = (tape.nx[i], tape.ny[i], tape.nz[i])

        # One [C, N] @ [N, R] matmul gathers every material column
        # (see integrator.gather_rows).  Past ONEHOT_MAX_ROWS the O(N·R)
        # one-hot is intractable; use the gather, whose transpose is a
        # scatter-add.
        if n <= ONEHOT_MAX_ROWS:
            onehot_T = (row_ids[:, None] == jnp.maximum(prim, 0)[None, :]
                        ).astype(dtype)
            g = jnp.matmul(matm_T_b, onehot_T,    # [C, R] component planes
                           precision=jax.lax.Precision.HIGHEST)
        else:
            g = jnp.take(matm_T_b, jnp.maximum(prim, 0), axis=1)
        emission = (g[0], g[1], g[2])
        diffuse = (g[3], g[4], g[5])
        specular = (g[6], g[7], g[8])
        refraction = (g[9], g[10], g[11])
        ior = g[12]
        shininess = g[13]

        u = uniforms[i]

        # --- shading math, decisions pinned by the tape -------------------
        # RandomShine (Raytracer.cs:51-56): z = exp(ln U / shininess).
        z_shine = jnp.where(jnp.isinf(shininess), 1.0,
                            jnp.exp(u[0] / shininess))
        rough_n = vm.create_horizon3_cs(normal, z_shine, u[1], u[2])
        cos = -vm.dot3(rough_n, d)

        lum = lambda c: LUM_R * c[0] + LUM_G * c[1] + LUM_B * c[2]
        diff_lum = lum(diffuse)
        spec_lum = lum(specular)
        refr_lum = lum(refraction)
        emis_lum = lum(emission)

        ior_in = jnp.where(inside, ior, air)
        ior_out = jnp.where(inside, air, ior)
        safe_out = jnp.where(ior_out == 0, 1.0, ior_out)
        ior_ratio = ior_in / safe_out
        sin_out = ior_ratio * vm.safe_sqrt(1.0 - cos * cos)
        cos_out = vm.safe_sqrt(1.0 - sin_out * sin_out)
        cos_f = jnp.where(f_live, cos, 1.0)
        cos_out_f = jnp.where(f_live, cos_out, 1.0)
        rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / \
            ((ior_out * cos_f) + (ior_in * cos_out_f))
        rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / \
            ((ior_in * cos_f) + (ior_out * cos_out_f))
        fresnel = (rs * rs + rp * rp) / 2.0

        spec_lum = jnp.where(f_live, spec_lum * fresnel, spec_lum)
        refr_lum = jnp.where(f_live, refr_lum * (1.0 - fresnel),
                             jnp.zeros_like(refr_lum))
        total_lum = diff_lum + spec_lum + refr_lum + emis_lum

        # --- outcomes ------------------------------------------------------
        te = (tint[0] * emission[0], tint[1] * emission[1],
              tint[2] * emission[2])
        terminal = ((code == BounceType.EMISSION)
                    | (code == BounceType.SPECULAR_FAIL)
                    | (code == BounceType.PURE_BLACK)
                    | (code == BounceType.RECURSION_COMPLETE))
        result = vm.where3(terminal, te, result)

        is_miss = code == BounceType.MISSED
        if scene.ambient_is_miss:
            miss = miss | is_miss
        else:
            miss = miss | (is_miss & (i == 0))
            result = vm.where3(is_miss & (i != 0), ambient, result)

        pick_refr = code == BounceType.TRANSMITTED
        pick_spec = code == BounceType.SPECULAR
        pick_diff = code == BounceType.DIFFUSE
        bounced = pick_refr | pick_spec | pick_diff

        refr_dir = tuple(
            rough_n[k] * (-cos_out) + (d[k] + rough_n[k] * cos) * ior_ratio
            for k in range(3))
        one = jnp.ones_like(cos)
        refr_tint = vm.where3(inside, (one, one, one), refraction)
        spec_dir = vm.reflect3(rough_n, d, cos)
        diff_dir = vm.create_horizon3_cs(normal, u[4], u[5], u[6])

        out_dir = vm.where3(pick_refr, refr_dir,
                            vm.where3(pick_spec, spec_dir, diff_dir))
        new_tint = vm.where3(pick_refr, refr_tint,
                             vm.where3(pick_spec, specular, diffuse))
        comp = jnp.maximum(total_lum, 1.0)
        new_tint = vm.scale3(new_tint, comp)

        d = vm.where3(bounced, out_dir, d)
        tint = vm.where3(bounced,
                         (tint[0] * new_tint[0], tint[1] * new_tint[1],
                          tint[2] * new_tint[2]), tint)
        return d, tint, result, miss

    one_r = jnp.ones((R,), dtype)
    zero_r = jnp.zeros((R,), dtype)
    init = (vm.unstack3(ray_d), (one_r, one_r, one_r),
            (zero_r, zero_r, zero_r), jnp.zeros((R,), bool))
    # Per-bounce remat: residuals stay a handful of [R] planes; recomputing
    # a replay bounce is pure elementwise + one one-hot matmul.
    body_fn = jax.checkpoint(body, prevent_cse=False) if remat else body
    d, tint, result, miss = jax.lax.fori_loop(0, recursion + 1, body_fn,
                                              init)
    return vm.stack3(*result), miss


def record_tape(scene: SceneArrays, ray_o, ray_d, uniforms,
                closest_fn=closest_hit, mesh=None) -> PathTape:
    """Stop-grad forward recording pass.

    The route is :func:`..config.trace_route`'s: the Triton
    megakernel (:func:`.fused.trace_fused` with ``want_tape=True``) on a GPU
    when the caller keeps the dense ``closest_hit``; otherwise the
    integrator's own loop body (``trace(..., want_tape=True)``), so the tape
    can never drift from the render path.  A given ``closest_fn`` (a BVH)
    is respected.

    ``mesh``: the device mesh when the rays are sharded over its ``rays``
    axis under GSPMD.  The kernel then runs on each device's own rays
    under ``shard_map``, since a kernel call cannot be partitioned by XLA.
    """
    from ..config import trace_route

    sg = jax.lax.stop_gradient
    args = (jax.tree.map(sg, scene), sg(ray_o), sg(ray_d), sg(uniforms))
    if (closest_fn is closest_hit
            and trace_route(scene, ray_o.dtype) == "triton"):
        from . import fused

        def rec(s, o, d, u):
            return fused.trace_fused(s, o, d, None, uniforms=u,
                                     want_tape=True)[2]

        if mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from ..parallel.mesh import RAYS_AXIS
            rec = shard_map(
                rec, mesh=mesh,
                in_specs=(P(), P(RAYS_AXIS), P(RAYS_AXIS),
                          P(None, None, RAYS_AXIS)),
                out_specs=P(None, RAYS_AXIS), check_vma=False)
    else:
        def rec(s, o, d, u):
            return trace(s, o, d, None, closest_fn=closest_fn, uniforms=u,
                         want_tape=True)[2]
    return jax.tree.map(sg, rec(*args))


def trace_replay(scene: SceneArrays, ray_o, ray_d, key,
                 closest_fn=closest_hit, grad_axis: str | None = None,
                 mesh=None):
    """Drop-in for :func:`..render.integrator.trace` on the TRAIN path:
    same estimator, ~selection-free backward.  With the XLA recorder the
    (color, miss) values and gradients are bit-identical to ``trace`` for
    the same key (tested); with the megakernel recorder the estimator is
    self-consistent, but a knife-edge branch pick may differ from XLA's for
    a tiny fraction of rays.  Forward-only rendering should keep using
    ``trace`` (or the megakernel) — the tape write is pure overhead there.

    ``mesh``: passed on to :func:`record_tape`.
    """
    if scene.debug_geom:
        # Flat geometry view has no bounce loop to replay.
        return trace(scene, ray_o, ray_d, key, closest_fn=closest_fn)
    uniforms = prepare_uniforms(key, ray_o.shape[0], scene.recursion + 1,
                                ray_o.dtype)
    tape = record_tape(scene, ray_o, ray_d, uniforms, closest_fn=closest_fn,
                       mesh=mesh)
    return replay(scene, ray_o, ray_d, uniforms, tape, grad_axis=grad_axis)
