"""Closest-hit query over the whole scene with material-level filtering.

This is the batched equivalent of the reference's per-primitive wrapper +
scene scan:

* ``Primitive.RayTrace`` (Primitive.cs:46-75): iterate candidates nearest
  first, apply ``Invert`` (flip the inside flag), cull inside hits on
  single-sided primitives, and skip the hit matching the previous bounce's
  hit (``Util.RayHitMatches``, Util.cs:179-192) — self-intersection avoidance
  WITHOUT epsilon ray offsets.
* ``Scene.RayTracePrimitives`` (Scene.cs:65-111): keep the closest surviving
  hit across all primitives.

Performance/AD structure — every implementation is split into two phases:

1. **Selection** (stop-gradient): find WHICH candidate wins — dense masked
   argmin over [R × N] grids, or BVH traversal.  Discrete, cheap to
   recompute, never on the AD tape; its [R × N] temporaries are dead after
   the argmin so XLA fuses them instead of spilling to HBM, and the backward
   pass never touches them.
2. **Winner evaluation** (differentiable): re-run the single winning
   primitive's intersection math per ray ([R]-shaped) to produce
   t/position/normal with gradients attached.

Two interchangeable closest-hit implementations share phase 2 and the
cross-table combine: :func:`closest_hit` (dense) and
:func:`make_bvh_closest_fn` (skip-link BVH for triangles).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..core.pytree import PyTreeNode
from ..scene.types import SceneArrays
from . import jnp_ref


class HitRecord(PyTreeNode):
    """Batched hit: ``prim == -1`` ⇒ miss (the reference's null Hit)."""

    prim: jnp.ndarray      # [R] int32 global primitive id, -1 = miss
    t: jnp.ndarray         # [R]
    position: jnp.ndarray  # [R, 3]
    normal: jnp.ndarray    # [R, 3]
    inside: jnp.ndarray    # [R] bool

    @property
    def found(self):
        return self.prim >= 0

    @classmethod
    def none(cls, n, dtype=jnp.float32):
        return cls(prim=jnp.full((n,), -1, jnp.int32),
                   t=jnp.zeros((n,), dtype),
                   position=jnp.zeros((n, 3), dtype),
                   normal=jnp.zeros((n, 3), dtype),
                   inside=jnp.zeros((n,), bool))


def _position_eps(dtype):
    """Tolerance for the skip-hit position match.

    The reference compares positions with a relative epsilon of 1e-24 in f64
    (Util.cs:18,41-74) — effectively exact.  In f32 the hit position is
    recomputed through different formulas between bounces, so a looser
    dtype-aware tolerance is needed.
    """
    return 1e-9 if jnp.dtype(dtype) == jnp.float64 else 1e-4


def _skip_match(ray_d, cand_pos, cand_inside, cand_prim, skip, eps):
    """Batched Util.RayHitMatches (Util.cs:179-192).

    a = candidate, b = skip (previous bounce's hit).  Match requires same
    primitive, nearly-equal position, and the inside-parity rule keyed on
    whether the new ray leaves along the skip hit's normal.
    """
    if skip is None:
        return jnp.zeros(cand_prim.shape, bool)
    same_prim = cand_prim == skip.prim[:, None]
    d2 = jnp.sum((cand_pos - skip.position[:, None, :]) ** 2, axis=-1)
    scale = 1.0 + jnp.sum(skip.position ** 2, axis=-1)[:, None]
    pos_close = d2 <= (eps * eps) * scale
    leaving = jnp.sum(ray_d * skip.normal, axis=-1)[:, None] > 0
    parity = jnp.where(leaving,
                       cand_inside != skip.inside[:, None],
                       cand_inside == skip.inside[:, None])
    return same_prim & pos_close & parity & (skip.prim >= 0)[:, None]


def _filter(mats, prim_ids, inside_geo, valid, ray_d, approx_pos, skip, eps):
    """Apply invert / two-sided / skip filtering to candidate grids.

    Returns (valid', inside') where inside' has the Invert flip applied
    (Hit.Inverted, Hit.cs:39-42 — flips only the flag; the geometric normal
    flip already happened in the primitive's inside handling).
    """
    safe_ids = jnp.maximum(prim_ids, 0)
    invert = jnp.take(mats.invert, safe_ids)[None, :]
    two_sided = jnp.take(mats.two_sided, safe_ids)[None, :]

    inside = jnp.where(invert, ~inside_geo, inside_geo)
    valid = valid & ~(inside & ~two_sided)
    match = _skip_match(ray_d, approx_pos, inside,
                        jnp.broadcast_to(prim_ids[None, :], inside.shape),
                        skip, eps)
    valid = valid & ~match
    return valid, inside


def _best(t, valid):
    """Masked argmin over the table axis → (idx [R], any [R])."""
    t = jnp.where(valid, t, jnp.inf)
    idx = jnp.argmin(t, axis=1)
    t_best = jnp.take_along_axis(t, idx[:, None], axis=1)[:, 0]
    return idx, jnp.isfinite(t_best)


def _fin(x):
    """Sanitize inf/NaN to 0 — losing winners evaluate to t = inf, and
    computing positions with inf would leak NaNs through the final selects
    in reverse-mode AD."""
    return jnp.where(jnp.isfinite(x), x, 0.0)


def _sg_tree(x):
    return None if x is None else jax.tree.map(jax.lax.stop_gradient, x)


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def _triangle_select_dense(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
    """Phase 1 (stop-grad): dense [rays, prims] scan → winner index per
    ray.  XLA fuses the candidate math into the argmin, so the grids are
    not written to device memory."""
    tri = scene.triangles
    tc = jnp_ref.triangle_candidates(tri, ray_o, ray_d, eps_behind)
    pos_approx = ray_o[:, None, :] + ray_d[:, None, :] * jnp.where(
        tc["valid"], tc["t"], 0.0)[..., None]
    valid, _ = _filter(scene.materials, tri.prim_id, tc["inside"],
                       tc["valid"], ray_d, pos_approx, skip, eps_pos)
    return _best(tc["t"], valid)


def _triangle_winner_eval(scene, idx, any_, ray_o, ray_d, eps_behind):
    """Phase 2 (differentiable): one Möller–Trumbore per ray on the winner.

    Shared by the dense and BVH paths.
    """
    tri = scene.triangles
    safe = jnp.maximum(idx, 0)
    g3 = lambda a: jnp.take(a, safe, axis=0)
    mt = jnp_ref.moller_trumbore(
        ray_o, ray_d, g3(tri.v0), g3(tri.e1), g3(tri.e2), g3(tri.normal),
        jnp.take(tri.mirror, safe), any_, eps_behind)
    prim_ids = jnp.take(tri.prim_id, safe)
    invert = jnp.take(scene.materials.invert, jnp.maximum(prim_ids, 0))
    inside = jnp.where(invert, ~mt["inside"], mt["inside"])
    any_ = any_ & mt["valid"]
    pos, nrm = jnp_ref.triangle_hit_detail(
        tri, safe, _fin(mt["u"]), _fin(mt["v"]), mt["inside"])
    return {
        "t": _fin(mt["t"]), "any": any_, "prim": prim_ids,
        "inside": inside, "position": pos, "normal": nrm,
    }


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def _sphere_select(scene, ray_o, ray_d, skip, eps_pos):
    """Phase 1 (stop-grad): [rays, prims] sphere scan (near+far roots) →
    (idx [R], use_near [R], any [R])."""
    sph = scene.spheres
    mats = scene.materials
    sc = jnp_ref.sphere_candidates(sph, ray_o, ray_d)

    def sphere_set(t_obj, valid, inside_flag):
        pos_obj = sc["o_obj"] + sc["d_obj"] * jnp.where(
            valid, t_obj, 0.0)[..., None]
        pos_w = (jnp.einsum("sij,rsj->rsi", sph.obj_to_world[:, :3, :3],
                            pos_obj) + sph.obj_to_world[None, :, :3, 3])
        inside = jnp.broadcast_to(inside_flag, valid.shape)
        valid2, _ = _filter(mats, sph.prim_id, inside, valid,
                            ray_d, pos_w, skip, eps_pos)
        t_w = jnp.sum(ray_d[:, None, :] * (pos_w - ray_o[:, None, :]),
                      axis=-1)
        return jnp.where(valid2, t_w, jnp.inf), valid2

    near_tw, near_valid = sphere_set(sc["t_near_obj"], sc["valid_near"],
                                     False)
    far_tw, far_valid = sphere_set(sc["t_far_obj"], sc["valid_far"], True)

    # Near root is always closer; prefer it when valid (the reference's
    # ordered candidate scan, Sphere.cs:199-209).
    tw = jnp.where(near_valid, near_tw, far_tw)
    valid = near_valid | far_valid
    tbest = jnp.where(valid, tw, jnp.inf)
    idx, any_ = _best(tbest, valid)
    use_near = jnp.take_along_axis(near_valid, idx[:, None], axis=1)[:, 0]
    return idx, use_near, any_


def _sphere_winner_eval(scene, idx, use_near, any_, ray_o, ray_d):
    """Phase 2 (differentiable): re-solve the winning sphere per ray
    (Sphere.DoRayTrace math on [R] gathered rows, Sphere.cs:175-209)."""
    sph = scene.spheres
    safe = jnp.maximum(idx, 0)
    take = lambda a: jnp.take(a, safe, axis=0)
    w2o = take(sph.world_to_obj)
    o_obj = jnp.einsum("rij,rj->ri", w2o[:, :3, :3], ray_o) + w2o[:, :3, 3]
    d_obj = jnp.einsum("rij,rj->ri", w2o[:, :3, :3], ray_d)
    d_obj = d_obj / vm.safe_sqrt(
        jnp.sum(d_obj * d_obj, axis=-1))[:, None]

    offset = o_obj - take(sph.center)
    b = -2.0 * jnp.sum(offset * d_obj, axis=-1)
    c = jnp.sum(offset * offset, axis=-1) - take(sph.radius) ** 2
    disc = b * b - 4.0 * c
    radix = jnp.sqrt(jnp.maximum(jnp.where(disc >= 0, disc, 1.0), 1e-20))
    t_obj = jnp.where(use_near, (b - radix) / 2.0, (b + radix) / 2.0)
    inside_geo = ~use_near

    pos, nrm, t = jnp_ref.sphere_hit_detail(sph, safe, ray_o, ray_d, o_obj,
                                            d_obj, _fin(t_obj), inside_geo)
    prim_ids = take(sph.prim_id)
    invert = jnp.take(scene.materials.invert, jnp.maximum(prim_ids, 0))
    inside = jnp.where(invert, ~inside_geo, inside_geo)
    return {
        "t": _fin(t), "any": any_ & (disc >= 0), "prim": prim_ids,
        "inside": inside, "position": pos, "normal": nrm,
    }


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------

def _plane_select(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
    pl = scene.planes
    pc = jnp_ref.plane_candidates(pl, ray_o, ray_d, eps_behind)
    pos_approx = ray_o[:, None, :] + ray_d[:, None, :] * jnp.where(
        pc["valid"], pc["t"], 0.0)[..., None]
    valid, _ = _filter(scene.materials, pl.prim_id, pc["inside"],
                       pc["valid"], ray_d, pos_approx, skip, eps_pos)
    return _best(pc["t"], valid)


def _plane_winner_eval(scene, idx, any_, ray_o, ray_d, eps_behind):
    pl = scene.planes
    safe = jnp.maximum(idx, 0)
    n = jnp.take(pl.normal, safe, axis=0)
    dist0 = jnp.take(pl.origin_dist, safe)
    ray_dist = jnp.sum(ray_o * n, axis=-1)
    denom = jnp.sum(ray_d * n, axis=-1)
    coplanar = (denom == 0) & (jnp.abs(dist0 - ray_dist)
                               <= eps_behind * (1.0 + jnp.abs(dist0)))
    t = jnp.where(denom != 0,
                  (dist0 - ray_dist) / jnp.where(denom == 0, 1.0, denom),
                  0.0)
    t = jnp.where(coplanar, 0.0, jnp.abs(t))
    inside_geo = jnp.where(coplanar, True, denom > 0)
    pos, nrm = jnp_ref.plane_hit_detail(pl, safe, ray_o, ray_d, _fin(t),
                                        inside_geo)
    prim_ids = jnp.take(pl.prim_id, safe)
    invert = jnp.take(scene.materials.invert, jnp.maximum(prim_ids, 0))
    inside = jnp.where(invert, ~inside_geo, inside_geo)
    return {
        "t": _fin(t), "any": any_, "prim": prim_ids,
        "inside": inside, "position": pos, "normal": nrm,
    }


# ---------------------------------------------------------------------------
# Combine
# ---------------------------------------------------------------------------

def _combine(tri_w, sph_w, pl_w):
    """Cross-table min reduction over the three winner records."""
    ts = jnp.stack([jnp.where(tri_w["any"], tri_w["t"], jnp.inf),
                    jnp.where(sph_w["any"], sph_w["t"], jnp.inf),
                    jnp.where(pl_w["any"], pl_w["t"], jnp.inf)], axis=1)
    table = jnp.argmin(ts, axis=1)
    found = jnp.isfinite(jnp.min(ts, axis=1))

    def pick3(a, b, c):
        cond0 = (table == 0)[..., None] if a.ndim == 2 else table == 0
        cond1 = (table == 1)[..., None] if a.ndim == 2 else table == 1
        return jnp.where(cond0, a, jnp.where(cond1, b, c))

    position = pick3(tri_w["position"], sph_w["position"], pl_w["position"])
    normal = pick3(tri_w["normal"], sph_w["normal"], pl_w["normal"])
    inside = pick3(tri_w["inside"], sph_w["inside"], pl_w["inside"])
    t = _fin(pick3(tri_w["t"], sph_w["t"], pl_w["t"]))
    prim = pick3(tri_w["prim"], sph_w["prim"], pl_w["prim"])
    prim = jnp.where(found, prim, -1)

    return HitRecord(prim=prim.astype(jnp.int32), t=t, position=position,
                     normal=normal, inside=inside)


def _closest_from_tri_select(scene, ray_o, ray_d, skip, tri_select_fn):
    """Common driver: stop-grad selection for all tables, differentiable
    winner evaluation, cross-table combine."""
    dtype = ray_o.dtype
    eps_behind = vm.near_enough(dtype)
    eps_pos = _position_eps(dtype)

    sg = jax.lax.stop_gradient
    scene_sg = _sg_tree(scene)
    o_sg, d_sg = sg(ray_o), sg(ray_d)
    skip_sg = _sg_tree(skip)

    tri_idx, tri_any = tri_select_fn(scene_sg, o_sg, d_sg, skip_sg,
                                     eps_behind, eps_pos)
    sph_idx, use_near, sph_any = _sphere_select(scene_sg, o_sg, d_sg,
                                                skip_sg, eps_pos)
    pl_idx, pl_any = _plane_select(scene_sg, o_sg, d_sg, skip_sg,
                                   eps_behind, eps_pos)

    tri_w = _triangle_winner_eval(scene, tri_idx, tri_any, ray_o, ray_d,
                                  eps_behind)
    sph_w = _sphere_winner_eval(scene, sph_idx, use_near, sph_any, ray_o,
                                ray_d)
    pl_w = _plane_winner_eval(scene, pl_idx, pl_any, ray_o, ray_d,
                              eps_behind)
    return _combine(tri_w, sph_w, pl_w)


def closest_hit(scene: SceneArrays, ray_o, ray_d, skip: HitRecord | None
                ) -> HitRecord:
    """Closest surviving hit across all primitive tables (dense selection).

    ``skip`` carries the previous bounce's hit per ray (prim == -1 ⇒ none).
    """
    return _closest_from_tri_select(scene, ray_o, ray_d, skip,
                                    _triangle_select_dense)


def make_bvh_closest_fn(bvh):
    """Closest-hit with triangle selection routed through the skip-link BVH
    (:func:`..bvh.traverse.traverse_closest`, a lockstep ``while_loop``
    walk).  Spheres and planes keep the dense scan.

    Traversal runs in the stop-grad selection phase and returns only the
    winning triangle index; gradients see exactly one triangle per ray.
    """
    from ..bvh.traverse import traverse_closest

    def tri_select_bvh(scene_sg, o_sg, d_sg, skip_sg, eps_behind, eps_pos):
        best_idx, _ = traverse_closest(bvh, scene_sg.triangles,
                                       scene_sg.materials, o_sg, d_sg,
                                       skip_sg, eps_behind, eps_pos)
        return jnp.maximum(best_idx, 0), best_idx >= 0

    def closest(scene: SceneArrays, ray_o, ray_d, skip) -> HitRecord:
        return _closest_from_tri_select(scene, ray_o, ray_d, skip,
                                        tri_select_bvh)

    return closest
