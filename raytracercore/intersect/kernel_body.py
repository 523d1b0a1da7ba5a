"""Per-row intersection bodies for the whole-path megakernel.

The intersection math (reference routines: Triangle.cs:76-146,
Sphere.cs:50-155, Plane.cs:36-66, dispatched through Primitive.RayTrace's
invert/two-sided/skip filtering, Primitive.cs:46-75) written once over a
block of rays held as flat component vectors, for :mod:`..render.fused`.

Tables are packed dense float/int matrices (see ``pack_tables``).  Each
``*_row`` function reads ONE table row with scalar loads and returns the
candidate hit of every ray in the block against it; :func:`closest_in_block`
walks the three tables with ``lax.fori_loop`` and keeps the nearest
surviving candidate.  Nothing here is unrolled over rows, so the kernel's
size does not grow with the scene.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Packed float-table column layouts.
TRI_F = 21       # v0(3) e1(3) e2(3) n(3) n0(3) n1(3) n2(3)
SPH_F = 28       # w2o rows (12), o2w rows (12), center(3), radius
PL_F = 4         # n(3), dist
# int columns: prim_id, flag(mirror/smooth packed), invert, two_sided


def pack_tables(scene):
    """SceneArrays → dense (float, int) matrices per primitive table."""
    mats = scene.materials

    def icols(prim_id, flag):
        safe = jnp.maximum(prim_id, 0)
        return jnp.stack(
            [prim_id, flag.astype(jnp.int32),
             jnp.take(mats.invert, safe).astype(jnp.int32),
             jnp.take(mats.two_sided, safe).astype(jnp.int32)], axis=1)

    tri = scene.triangles
    tf = jnp.concatenate([tri.v0, tri.e1, tri.e2, tri.normal,
                          tri.n0, tri.n1, tri.n2], axis=1)
    # flag bit0 = mirror, bit1 = smooth
    tflag = tri.mirror.astype(jnp.int32) + 2 * tri.smooth.astype(jnp.int32)
    ti = icols(tri.prim_id, tflag)

    sph = scene.spheres
    w2o = sph.world_to_obj[:, :3, :].reshape(-1, 12)
    o2w = sph.obj_to_world[:, :3, :].reshape(-1, 12)
    sf = jnp.concatenate([w2o, o2w, sph.center, sph.radius[:, None]], axis=1)
    si = icols(sph.prim_id, jnp.zeros_like(sph.prim_id))

    pln = scene.planes
    pf = jnp.concatenate([pln.normal, pln.origin_dist[:, None]], axis=1)
    pi = icols(pln.prim_id, jnp.zeros_like(pln.prim_id))
    return tf, ti, sf, si, pf, pi


def make_skip_match(d3, skip, eps_pos):
    """Batched Util.RayHitMatches (Util.cs:179-192) over a ray block.

    ``skip`` is a dict with keys ``prim`` (i32, -1 ⇒ no previous hit),
    ``px py pz`` and ``nx ny nz`` (f32) and ``inside`` (bool).  Returns
    ``match(prim_id, px, py, pz, inside)``.
    """
    d_x, d_y, d_z = d3
    k_prim = skip["prim"]
    k_px, k_py, k_pz = skip["px"], skip["py"], skip["pz"]
    k_leaving = (d_x * skip["nx"] + d_y * skip["ny"]
                 + d_z * skip["nz"]) > 0
    k_inside = skip["inside"]
    k_scale = 1.0 + k_px * k_px + k_py * k_py + k_pz * k_pz

    def match(prim_id, px, py, pz, inside):
        d2 = ((px - k_px) ** 2 + (py - k_py) ** 2 + (pz - k_pz) ** 2)
        pos_close = d2 <= (eps_pos * eps_pos) * k_scale
        # leaving ? inside != k : inside == k
        parity = jnp.logical_xor(k_leaving, inside == k_inside)
        return (k_prim == prim_id) & (k_prim >= 0) & pos_close & parity

    return match


def triangle_row(tf, ti, t, o3, d3, eps_behind, skip_match,
                 coplanar=True, any_smooth=True):
    """Möller–Trumbore against triangle row ``t`` (Triangle.cs:148-224
    semantics, including the mirrored-quad UV rule).  Returns
    ``(ok, t, prim, inside, pos3, nrm3)``; ``inside`` has the Invert flip
    applied.

    Static specializations:

    * ``coplanar=False`` drops the degenerate ray-in-plane branch
      (det == 0 exactly AND origin on the plane).  This matches the
      reference's own production tier: its AVX path (RayTraceAVXFaster,
      Triangle.cs:107-125) has no coplanar branch either (it NaN-scrubs
      1/det to 0 and falls through); only the scalar fallback
      (Triangle.cs:161-171) implements it.  det == 0 has measure zero
      under jittered camera rays.
    * ``any_smooth=False`` (no triangle interpolates vertex normals)
      folds the smooth-normal block to the face-normal flip, which is
      exact, not an approximation.
    """
    o_x, o_y, o_z = o3
    d_x, d_y, d_z = d3
    v0x, v0y, v0z = tf[t, 0], tf[t, 1], tf[t, 2]
    e1x, e1y, e1z = tf[t, 3], tf[t, 4], tf[t, 5]
    e2x, e2y, e2z = tf[t, 6], tf[t, 7], tf[t, 8]
    fnx, fny, fnz = tf[t, 9], tf[t, 10], tf[t, 11]
    prim = ti[t, 0]
    mirror = (ti[t, 1] & 1) != 0
    smooth = (ti[t, 1] & 2) != 0
    inv_f = ti[t, 2] != 0
    two_s = ti[t, 3] != 0

    sx = d_y * e2z - d_z * e2y
    sy = d_z * e2x - d_x * e2z
    sz = d_x * e2y - d_y * e2x
    det = e1x * sx + e1y * sy + e1z * sz
    fx, fy, fz = o_x - v0x, o_y - v0y, o_z - v0z
    inv = jnp.where(det != 0, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    u_n = inv * (fx * sx + fy * sy + fz * sz)
    ocx = fy * e1z - fz * e1y
    ocy = fz * e1x - fx * e1z
    ocz = fx * e1y - fy * e1x
    v_n = inv * (d_x * ocx + d_y * ocy + d_z * ocz)
    t_n = inv * (e2x * ocx + e2y * ocy + e2z * ocz)

    if coplanar:
        on_plane = jnp.abs(fx * fnx + fy * fny + fz * fnz) <= eps_behind
        degen = (det == 0) & on_plane
        u = jnp.where(degen, e1x * fx + e1y * fy + e1z * fz, u_n)
        v = jnp.where(degen, e2x * fx + e2y * fy + e2z * fz, v_n)
        # t_n is already 0 where det == 0 (inv is zeroed), which equals
        # the coplanar branch's dist = 0.
        tt = t_n
        inside_geo = degen | (inv < 0)
        det_ok = (det != 0) | degen
    else:
        u, v, tt = u_n, v_n, t_n
        inside_geo = inv < 0
        det_ok = det != 0

    uv_lim = jnp.where(mirror, v, u + v)
    ok = ((u >= 0) & (u <= 1) & (v >= 0) & (uv_lim <= 1)
          & (tt >= -eps_behind) & det_ok & (prim >= 0))
    inside = jnp.logical_xor(inside_geo, inv_f)
    ok = ok & (two_s | ~inside)

    # Exact hit position (Triangle.cs:192).
    hx = v0x + e1x * u + e2x * v
    hy = v0y + e1y * u + e2y * v
    hz = v0z + e1z * u + e2z * v
    ok = ok & ~skip_match(prim, hx, hy, hz, inside)

    # Normal (Triangle.GetNormal, Triangle.cs:209-224).
    flip = jnp.where(inside_geo, -1.0, 1.0)
    flx, fly, flz = fnx * flip, fny * flip, fnz * flip
    if any_smooth:
        n0x, n0y, n0z = tf[t, 12], tf[t, 13], tf[t, 14]
        n1x, n1y, n1z = tf[t, 15], tf[t, 16], tf[t, 17]
        n2x, n2y, n2z = tf[t, 18], tf[t, 19], tf[t, 20]
        w2 = u + v
        ix = n0x * u + n1x * v + n2x * w2
        iy = n0y * u + n1y * v + n2y * w2
        iz = n0z * u + n1z * v + n2z * w2
        rl = jax.lax.rsqrt(jnp.maximum(ix * ix + iy * iy + iz * iz, 1e-30))
        ix, iy, iz = ix * rl, iy * rl, iz * rl
        dotf = ix * fnx + iy * fny + iz * fnz
        # inside: reflect the interpolated normal through the face plane
        rx = ix - fnx * (2.0 * dotf)
        ry = iy - fny * (2.0 * dotf)
        rz = iz - fnz * (2.0 * dotf)
        nx = jnp.where(smooth, jnp.where(inside_geo, rx, ix), flx)
        ny = jnp.where(smooth, jnp.where(inside_geo, ry, iy), fly)
        nz = jnp.where(smooth, jnp.where(inside_geo, rz, iz), flz)
    else:
        nx, ny, nz = flx, fly, flz
    return ok, tt, prim, inside, (hx, hy, hz), (nx, ny, nz)


def sphere_row(sf, si, s, o3, d3, skip_match):
    """Two-root transformed-sphere intersection against row ``s``
    (Sphere.cs:156-209): the near root when it survives filtering, else
    the far one."""
    o_x, o_y, o_z = o3
    d_x, d_y, d_z = d3
    m = lambda k: sf[s, k]
    oox = m(0) * o_x + m(1) * o_y + m(2) * o_z + m(3)
    ooy = m(4) * o_x + m(5) * o_y + m(6) * o_z + m(7)
    ooz = m(8) * o_x + m(9) * o_y + m(10) * o_z + m(11)
    ddx = m(0) * d_x + m(1) * d_y + m(2) * d_z
    ddy = m(4) * d_x + m(5) * d_y + m(6) * d_z
    ddz = m(8) * d_x + m(9) * d_y + m(10) * d_z
    dlen = jax.lax.rsqrt(jnp.maximum(ddx * ddx + ddy * ddy + ddz * ddz,
                                     1e-30))
    ddx, ddy, ddz = ddx * dlen, ddy * dlen, ddz * dlen

    cx, cy, cz, rad = m(24), m(25), m(26), m(27)
    fx, fy, fz = oox - cx, ooy - cy, ooz - cz
    b = -2.0 * (fx * ddx + fy * ddy + fz * ddz)
    c = fx * fx + fy * fy + fz * fz - rad * rad
    disc = b * b - 4.0 * c
    has_root = disc >= 0
    radix = jnp.sqrt(jnp.where(has_root, disc, 0.0))
    prim = si[s, 0]
    inv_f = si[s, 2] != 0
    two_s = si[s, 3] != 0
    any_hit = has_root & (radix >= -b) & (prim >= 0)
    inv_rad = 1.0 / rad

    def eval_root(t_obj, valid, geo_inside: bool):
        ts = jnp.where(valid, t_obj, 0.0)
        px = oox + ddx * ts
        py = ooy + ddy * ts
        pz = ooz + ddz * ts
        # World position via obj_to_world (Sphere.cs:158-166).
        wx = m(12) * px + m(13) * py + m(14) * pz + m(15)
        wy = m(16) * px + m(17) * py + m(18) * pz + m(19)
        wz = m(20) * px + m(21) * py + m(22) * pz + m(23)
        # Object normal, then MatrixToNormal = w2o^T (Sphere.cs:36).
        qx = (px - cx) * inv_rad
        qy = (py - cy) * inv_rad
        qz = (pz - cz) * inv_rad
        nwx = m(0) * qx + m(4) * qy + m(8) * qz
        nwy = m(1) * qx + m(5) * qy + m(9) * qz
        nwz = m(2) * qx + m(6) * qy + m(10) * qz
        nrl = jax.lax.rsqrt(
            jnp.maximum(nwx * nwx + nwy * nwy + nwz * nwz, 1e-30))
        # Geometric-inside hits negate the normal (Sphere.cs:168-169).
        nrl = -nrl if geo_inside else nrl
        inside_s = jnp.logical_not(inv_f) if geo_inside else inv_f
        inside = jnp.broadcast_to(inside_s, valid.shape)
        valid = valid & (two_s | ~inside)
        valid = valid & ~skip_match(prim, wx, wy, wz, inside)
        tw = d_x * (wx - o_x) + d_y * (wy - o_y) + d_z * (wz - o_z)
        return tw, valid, inside, (wx, wy, wz), \
            (nwx * nrl, nwy * nrl, nwz * nrl)

    t_n, v_n, in_n, pos_n, nrm_n = eval_root((b - radix) / 2.0,
                                             any_hit & (radix < b), False)
    t_f, v_f, in_f, pos_f, nrm_f = eval_root((b + radix) / 2.0, any_hit,
                                             True)
    pick = lambda a, bq: jnp.where(v_n, a, bq)
    return (v_n | v_f, pick(t_n, t_f), prim, pick(in_n, in_f),
            tuple(map(pick, pos_n, pos_f)), tuple(map(pick, nrm_n, nrm_f)))


def plane_row(pf, pi, q, o3, d3, eps_behind, skip_match):
    """Infinite-plane intersection against row ``q``, with the coplanar
    special case (Plane.cs:36-66)."""
    o_x, o_y, o_z = o3
    d_x, d_y, d_z = d3
    qnx, qny, qnz, dist0 = pf[q, 0], pf[q, 1], pf[q, 2], pf[q, 3]
    prim = pi[q, 0]
    inv_f = pi[q, 2] != 0
    two_s = pi[q, 3] != 0
    ray_dist = qnx * o_x + qny * o_y + qnz * o_z
    denom = qnx * d_x + qny * d_y + qnz * d_z
    coplanar = (denom == 0) & (
        jnp.abs(dist0 - ray_dist) <= eps_behind * (1.0 + jnp.abs(dist0)))
    tt = jnp.where(denom != 0,
                   (dist0 - ray_dist) / jnp.where(denom == 0, 1.0, denom),
                   0.0)
    ahead = (denom != 0) & (tt >= -eps_behind)
    t_abs = jnp.where(coplanar, 0.0, jnp.abs(tt))
    inside_geo = coplanar | (denom > 0)
    ok = (coplanar | ahead) & (prim >= 0)
    inside = jnp.logical_xor(inside_geo, inv_f)
    ok = ok & (two_s | ~inside)
    hx = o_x + d_x * t_abs
    hy = o_y + d_y * t_abs
    hz = o_z + d_z * t_abs
    ok = ok & ~skip_match(prim, hx, hy, hz, inside)
    flip = jnp.where(inside_geo, -1.0, 1.0)
    return ok, t_abs, prim, inside, (hx, hy, hz), \
        (qnx * flip, qny * flip, qnz * flip)


def _commit(best, cand):
    """Keep the candidate where it survives and is strictly nearer."""
    ok, tt, prim, inside, pos3, nrm3 = cand
    b_t, b_prim, b_inside, b_pos, b_nrm = best
    better = ok & (tt < b_t)
    w = lambda a, b: jnp.where(better, a, b)
    return (w(tt, b_t), w(prim, b_prim), w(inside, b_inside),
            tuple(map(w, pos3, b_pos)), tuple(map(w, nrm3, b_nrm)))


def closest_in_block(tables, o3, d3, skip_match, eps_behind,
                     coplanar=True, any_smooth=True):
    """Closest surviving hit of every ray in the block over all tables.

    Returns ``(t, prim, inside, pos3, nrm3)``; ``prim == -1`` ⇒ miss.  Ties
    keep the earlier table (triangles, then spheres, then planes), as the
    dense XLA path's cross-table combine does.
    """
    tf, ti, sf, si, pf, pi = tables
    zero = jnp.zeros_like(o3[0])
    best = (jnp.full_like(zero, jnp.inf), jnp.full(zero.shape, -1, jnp.int32),
            jnp.zeros(zero.shape, bool), (zero, zero, zero),
            (zero, zero, zero))
    rows = (
        (tf.shape[0], lambda r: triangle_row(tf, ti, r, o3, d3, eps_behind,
                                             skip_match, coplanar,
                                             any_smooth)),
        (sf.shape[0], lambda r: sphere_row(sf, si, r, o3, d3, skip_match)),
        (pf.shape[0], lambda r: plane_row(pf, pi, r, o3, d3, eps_behind,
                                          skip_match)),
    )
    for n, row in rows:
        best = jax.lax.fori_loop(
            0, n, lambda r, b, row=row: _commit(b, row(r)), best)
    return best
