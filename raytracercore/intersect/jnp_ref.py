"""Batched jnp intersection kernels (reference implementations).

These are the batched replacements for the reference's AVX2 intersection
routines: instead of one ray against one primitive with 4-lane SIMD
(Triangle.RayTraceAVXFaster, Triangle.cs:76-146; Sphere.RayTraceAVX,
Sphere.cs:50-155; AABB slab, AABB.cs:107-142), every function here evaluates a
dense ``[R rays × N primitives]`` grid with masked reductions.  They double as
the correctness oracle for the megakernel's row bodies (intersect/kernel_body.py).

Conventions:
* rays: ``ray_o``, ``ray_d`` are ``[R, 3]``; directions unit length.
* miss sentinel: ``t = +inf`` with ``valid = False``.
* candidate records stay in SoA form; positions/normals are only computed for
  reduced winners by :mod:`.dispatch` to bound memory at ``O(R·N)`` scalars.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.types import Planes, Spheres, Triangles

INF = jnp.inf


def _dot_rn(a, b):
    """Dot of [R, 1, 3] against [1, N, 3] → [R, N]."""
    return jnp.sum(a * b, axis=-1)


def moller_trumbore(o, d, v0, e1, e2, normal, mirror, table_ok, near_enough):
    """Möller–Trumbore core on broadcast-compatible operand shapes.

    Mirrors the scalar path Triangle.DoRayTrace (Triangle.cs:148-207)
    including the degenerate ray-in-plane branch (:161-171), backface
    ``inside = det-reciprocal < 0`` logic (:179) and the behind-ray cull at
    ``-NearEnough`` (:189).  The ``mirror`` flag widens the UV test from
    ``u+v ≤ 1`` to ``v ≤ 1`` (parallelogram, :118/:167).

    Shapes: vector operands [..., 3]; mirror/table_ok bool [...].
    Returns dict of [...] arrays: t, u, v, inside, valid.
    """
    dot = lambda a, b: jnp.sum(a * b, axis=-1)
    side = jnp.cross(d, e2)
    det = dot(e1, side)                  # Edge0to1 · (d × e2)
    offset = o - v0

    # Non-degenerate path
    inv_det = jnp.where(det != 0, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    u_n = inv_det * dot(offset, side)
    off_cross = jnp.cross(offset, e1)
    v_n = inv_det * dot(d, off_cross)
    t_n = inv_det * dot(e2, off_cross)
    inside_n = inv_det < 0

    # Degenerate path: ray origin lies in the triangle plane (det == 0).
    # The reference then tests *unprojected* UVs u = e1·offset, v = e2·offset
    # (Triangle.cs:161-171) and reports a t=0 hit with inside=True.
    # Deviation: the reference omits the "origin actually on the plane" check
    # its comment assumes, which fabricates t=0 hits for rays exactly
    # parallel to a triangle's plane (unreachable with f64 jittered camera
    # rays, common with batched axis-aligned rays).  We add the check.
    u_d = dot(e1, offset)
    v_d = dot(e2, offset)
    on_plane = jnp.abs(dot(offset, normal)) <= near_enough

    degenerate = (det == 0) & on_plane

    u = jnp.where(degenerate, u_d, u_n)
    v = jnp.where(degenerate, v_d, v_n)
    t = jnp.where(degenerate, 0.0, t_n)
    inside = jnp.where(degenerate, True, inside_n)

    uv_limit = jnp.where(mirror, v, u + v)
    uv_ok = (u >= 0) & (u <= 1) & (v >= 0) & (uv_limit <= 1)
    ahead = degenerate | (t >= -near_enough)
    # det == 0 off-plane is a miss (the zeroed inv_det would otherwise make
    # u = v = t = 0 pass every test).
    solvable = (det != 0) | degenerate
    valid = uv_ok & ahead & solvable & table_ok

    t = jnp.where(valid, t, INF)
    return {"t": t, "u": u, "v": v, "inside": inside, "valid": valid}


def triangle_candidates(tri: Triangles, ray_o, ray_d, near_enough):
    """Möller–Trumbore over all (ray, triangle) pairs → [R, T] grids."""
    return moller_trumbore(
        ray_o[:, None, :], ray_d[:, None, :],
        tri.v0[None, :, :], tri.e1[None, :, :], tri.e2[None, :, :],
        tri.normal[None, :, :], tri.mirror[None, :],
        (tri.prim_id >= 0)[None, :], near_enough)


def triangle_hit_detail(tri: Triangles, idx, u, v, inside):
    """Exact position/normal for chosen triangle hits.

    Args: idx [R] triangle-table index, u/v [R] barycentric-ish coords,
    inside [R].  Position = v0 + e1·u + e2·v (Triangle.cs:192).  Normal per
    Triangle.GetNormal (Triangle.cs:209-224) — NOTE the reference's
    non-standard interpolation weights ``(u, v, u+v)``, reproduced for parity.
    """
    take = lambda a: jnp.take(a, idx, axis=0)
    v0, e1, e2 = take(tri.v0), take(tri.e1), take(tri.e2)
    position = v0 + e1 * u[:, None] + e2 * v[:, None]

    face_n = take(tri.normal)
    smooth = jnp.take(tri.smooth, idx)

    n_interp = (take(tri.n0) * u[:, None] + take(tri.n1) * v[:, None]
                + take(tri.n2) * (u + v)[:, None])
    n_interp = vm.normalize(n_interp, eps=1e-30)
    # Inside: reflect the interpolated normal through the face plane
    # (Triangle.cs:216-218); for flat shading just negate.
    n_interp_in = n_interp - face_n * (
        2.0 * vm.vdot(n_interp, face_n) / vm.vdot(face_n, face_n))
    n_smooth = jnp.where(inside[:, None], n_interp_in, n_interp)
    n_flat = jnp.where(inside[:, None], -face_n, face_n)

    normal = jnp.where(smooth[:, None], n_smooth, n_flat)
    return position, normal


def sphere_candidates(sph: Spheres, ray_o, ray_d):
    """Quadratic sphere test over all (ray, sphere) pairs, transformed
    spheres included.

    Mirrors Sphere.DoRayTrace (Sphere.cs:175-209): transform the ray into
    object space, solve ``t² - b·t + c = 0`` with ``b = -2·offset·dir``,
    NaN-tolerant miss test ``!(radix >= -b)`` (:196), near hit (inside=False)
    valid only when ``radix < b`` (origin before the sphere), far hit
    (inside=True) always returned on intersection (:199-209).

    Returns dict of [R, S] arrays: t_near, t_far (world-metric distances),
    valid_near, valid_far, plus object-space rays for detail reconstruction.
    """
    w2o = sph.world_to_obj                     # [S, 4, 4]
    o_obj = (jnp.einsum("sij,rj->rsi", w2o[:, :3, :3], ray_o)
             + w2o[None, :, :3, 3])            # [R, S, 3]
    d_obj = jnp.einsum("sij,rj->rsi", w2o[:, :3, :3], ray_d)
    # Ray.Transform re-normalizes the direction (Ray.cs:43-50).
    d_len = jnp.sqrt(jnp.sum(d_obj * d_obj, axis=-1))
    d_obj = d_obj / d_len[..., None]

    offset = o_obj - sph.center[None, :, :]
    b = -2.0 * jnp.sum(offset * d_obj, axis=-1)
    c = jnp.sum(offset * offset, axis=-1) - (sph.radius ** 2)[None, :]
    disc = b * b - 4.0 * c
    # The reference uses a NaN radix as the miss signal (`!(radix >= -b)`,
    # Sphere.cs:196); NaNs poison reverse-mode AD through jnp.where, so the
    # discriminant test is explicit here with identical semantics.
    has_root = disc >= 0
    # Floored sqrt: the derivative at disc=0 (tangent rays) is infinite and
    # would NaN reverse-mode AD through the later wheres.
    radix = jnp.sqrt(jnp.maximum(jnp.where(has_root, disc, 1.0), 1e-20))

    table_ok = (sph.prim_id >= 0)[None, :]
    any_hit = has_root & (radix >= -b) & table_ok
    both = radix < b

    t_near_obj = (b - radix) / 2.0
    t_far_obj = (b + radix) / 2.0

    valid_near = any_hit & both
    valid_far = any_hit

    return {
        "o_obj": o_obj, "d_obj": d_obj,
        "t_near_obj": jnp.where(valid_near, t_near_obj, INF),
        "t_far_obj": jnp.where(valid_far, t_far_obj, INF),
        "valid_near": valid_near, "valid_far": valid_far,
    }


def sphere_hit_detail(sph: Spheres, idx, ray_o, ray_d, o_obj, d_obj, t_obj,
                      inside):
    """World position/normal/distance for chosen sphere hits
    (Sphere.GetHit, Sphere.cs:156-173).

    Args: idx [R] sphere-table index; o_obj/d_obj/t_obj [R, 3]/[R] selected
    object-space ray and root; inside [R].
    Returns (position, normal, t_world).
    """
    take = lambda a: jnp.take(a, idx, axis=0)
    center, radius = take(sph.center), take(sph.radius)
    o2w, nmat = take(sph.obj_to_world), take(sph.normal_mat)
    transformed = jnp.take(sph.transformed, idx)

    pos_obj = o_obj + d_obj * t_obj[:, None]
    n_obj = (pos_obj - center) / radius[:, None]

    pos_w = (jnp.einsum("rij,rj->ri", o2w[:, :3, :3], pos_obj)
             + o2w[:, :3, 3])
    n_w = vm.normalize(jnp.einsum("rij,rj->ri", nmat, n_obj), eps=1e-30)
    t_w = jnp.sum(ray_d * (pos_w - ray_o), axis=-1)

    position = jnp.where(transformed[:, None], pos_w, pos_obj)
    normal = jnp.where(transformed[:, None], n_w, n_obj)
    t = jnp.where(transformed, t_w, t_obj)

    normal = jnp.where(inside[:, None], -normal, normal)
    return position, normal, t


def plane_candidates(pl: Planes, ray_o, ray_d, near_enough):
    """Infinite-plane test (Plane.DoRayTrace, Plane.cs:36-66).

    Coplanar special case: denom == 0 and the origin on the plane → t=0 hit
    with inside=True (:40-41).  Otherwise ``t = (dist - o·n)/denom`` with the
    behind-ray tolerance, inside when the ray runs along the normal (:55-60).

    Returns dict of [R, P]: t, inside, valid.
    """
    n = pl.normal[None, :, :]
    ray_dist = _dot_rn(ray_o[:, None, :], n)
    denom = _dot_rn(ray_d[:, None, :], n)
    dist0 = pl.origin_dist[None, :]

    table_ok = (pl.prim_id >= 0)[None, :]

    coplanar = (denom == 0) & (jnp.abs(dist0 - ray_dist)
                               <= near_enough * (1.0 + jnp.abs(dist0)))
    t = jnp.where(denom != 0,
                  (dist0 - ray_dist) / jnp.where(denom == 0, 1.0, denom),
                  0.0)
    ahead = (denom != 0) & (t >= -near_enough)
    # Reference recomputes distance as |hitPos - origin| (Plane.cs:61) — for
    # a unit direction that is |t|.
    t = jnp.abs(t)

    inside = jnp.where(coplanar, True, denom > 0)
    valid = (coplanar | ahead) & table_ok
    t = jnp.where(valid, jnp.where(coplanar, 0.0, t), INF)
    return {"t": t, "inside": inside, "valid": valid}


def plane_hit_detail(pl: Planes, idx, ray_o, ray_d, t, inside):
    """Position/normal for chosen plane hits."""
    n = jnp.take(pl.normal, idx, axis=0)
    position = ray_o + ray_d * t[:, None]
    normal = jnp.where(inside[:, None], -n, n)
    return position, normal


def aabb_slab(box_min, box_max, ray_o, ray_d):
    """AABB slab test over all (ray, box) pairs (AABB.Intersect,
    AABB.cs:107-142 AVX / :154-197 scalar).

    Zero direction components map to ±inf slab distances (the AVX blend at
    AABB.cs:116-123).  Returns (near [R, B], far [R, B]); miss ⇔ NaN/empty
    interval — callers test ``near <= far`` (false for NaN).
    """
    o = ray_o[:, None, :]
    d = ray_d[:, None, :]
    inv = jnp.where(d != 0, 1.0 / jnp.where(d == 0, 1.0, d), INF)
    t0 = (box_min[None, :, :] - o) * inv
    t1 = (box_max[None, :, :] - o) * inv
    # When d == 0: inside the slab ⇒ (-inf, +inf); outside ⇒ empty.
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    zero_d = d == 0
    inside_slab = (o >= box_min[None, :, :]) & (o <= box_max[None, :, :])
    lo = jnp.where(zero_d, jnp.where(inside_slab, -INF, INF), lo)
    hi = jnp.where(zero_d, jnp.where(inside_slab, INF, -INF), hi)
    near = jnp.max(lo, axis=-1)
    far = jnp.min(hi, axis=-1)
    return near, far
