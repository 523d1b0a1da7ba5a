"""Batched 3-vector / 4x4-matrix math for the path tracer.

The reference implementation (RaytracerCore) carries homogeneous Vec4D values
(W=1 point, W=0 direction) and hand-written AVX2 kernels
(``RaytracerCore/Vectors/Vec4D.cs``, ``SIMDHelpers.cs``).  Here everything is
a batched ``[..., 3]`` jnp array; the vectorization axis is *rays*, not vector
lanes, so XLA and the kernels get dense, fusable elementwise work instead
of 4-wide shuffles.

Where a formula must match the reference for image parity, the docstring cites
the C# source (file:line relative to the reference's RaytracerCore/ directory).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Behind-ray tolerance used by intersectors (Util.cs:18 ``NearEnough = 1e-24``).
# The reference runs in f64 where 1e-24 acts as "essentially exact"; our default
# compute dtype is f32, so kernels take a dtype-aware epsilon from
# ``near_enough(dtype)`` instead of using the raw constant.
NEAR_ENOUGH_F64 = 1e-24
NEAR_ENOUGH_F32 = 1e-7


def near_enough(dtype) -> float:
    """Behind-ray epsilon matched to the compute dtype."""
    if jnp.dtype(dtype) == jnp.float64:
        return NEAR_ENOUGH_F64
    return NEAR_ENOUGH_F32


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def vdot(a, b):
    """Batched dot product, keepdims=True (convenient for scaling vectors)."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    """Batched 3-D cross product (Vec4D.cs:357, W=0 result)."""
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def squared_length(a):
    return jnp.sum(a * a, axis=-1)


def normalize(a, eps=0.0):
    """Normalize over the trailing axis.

    With ``eps=0`` a zero vector yields NaN, matching reference semantics
    (Vec4D.Normalize divides by the length unconditionally, Vec4D.cs:321).
    """
    n = jnp.sqrt(jnp.sum(a * a, axis=-1, keepdims=True))
    if eps:
        n = jnp.maximum(n, eps)
    return a / n


def safe_normalize(a, fallback=None):
    """Normalize; rows with (near-)zero length become ``fallback`` (default x̂)."""
    sq = jnp.sum(a * a, axis=-1, keepdims=True)
    tiny = jnp.asarray(np.finfo(jnp.result_type(a)).tiny, a.dtype)
    good = sq > tiny
    n = jnp.where(good, jnp.sqrt(jnp.where(good, sq, 1.0)), 1.0)
    out = a / n
    if fallback is None:
        fallback = jnp.array([1.0, 0.0, 0.0], dtype=a.dtype)
    return jnp.where(good, out, fallback)


def create_horizontal(v):
    """A unit vector horizontal to ``v``.

    Mirrors ``Vec4D.CreateHorizontal`` (Vec4D.cs:33-43): cross against the
    arbitrary up vector (0,0,1); if that degenerates (v ∥ ẑ), return (1,0,0).
    """
    up = jnp.zeros_like(v).at[..., 2].set(1.0)
    c = cross(v, up)
    return safe_normalize(c)


def rotate_about_axis(vec, axis, theta):
    """Rodrigues rotation of ``vec`` about unit ``axis`` by angle ``theta``.

    Equivalent to ``MatrixTransforms.Rotate(theta, axis) * vec``
    (MatrixTransforms.cs:25-37) without materializing the matrix.
    ``theta`` has shape ``vec.shape[:-1]``.
    """
    ct = jnp.cos(theta)[..., None]
    st = jnp.sin(theta)[..., None]
    return (
        vec * ct
        + cross(axis, vec) * st
        + axis * vdot(axis, vec) * (1.0 - ct)
    )


def safe_sqrt(x, floor=1e-20):
    """sqrt with the argument floored away from 0.

    ``sqrt`` has an infinite derivative at 0; under reverse-mode AD the
    resulting inf/NaN leaks through ``jnp.where`` even for unselected
    branches (0·inf = NaN).  Flooring keeps the forward value numerically
    identical (≤1e-10 for the default floor) and the gradient finite.
    """
    return jnp.sqrt(jnp.maximum(x, floor))


def create_horizon(pole, z, theta):
    """Point on the cone of height ``z`` around unit ``pole``, azimuth ``theta``.

    Mirrors ``Vec4D.CreateHorizon`` (Vec4D.cs:52-58):
    ``Rotate(theta, pole) * (pole*z + horizontal*sqrt(1-z^2))``.
    This is the basis of every BRDF sample in the reference integrator.
    """
    horiz = create_horizontal(pole)
    s = safe_sqrt(1.0 - z * z)[..., None]
    base = pole * z[..., None] + horiz * s
    return rotate_about_axis(base, pole, theta)


def reflect(normal, incoming, cos):
    """Mirror ``incoming`` about ``normal``; ``cos = -normal·incoming``.

    Mirrors ``Raytracer.Reflection`` (Raytracer.cs:58-61).
    """
    return incoming + normal * (2.0 * cos)[..., None]


# ---------------------------------------------------------------------------
# 4x4 homogeneous transforms (host-side construction uses numpy f64; the same
# functions work on jnp arrays for device-side use).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Component-tuple math: (x, y, z) tuples of [R] arrays.
#
# Flat [R] component arrays keep every elementwise op on contiguous rays,
# where [..., 3] interleaves the components.  Convention: module
# boundaries exchange [R, 3]; kernels split at entry (``unstack3``) and
# stack once at exit (``stack3``) — the two conversions are cheap relative
# to the op-count between them.
# ---------------------------------------------------------------------------

def unstack3(a):
    """[..., 3] → (x, y, z) component views."""
    return a[..., 0], a[..., 1], a[..., 2]


def stack3(x, y, z):
    return jnp.stack([x, y, z], axis=-1)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def add3(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub3(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def scale3(a, s):
    return a[0] * s, a[1] * s, a[2] * s


def where3(c, a, b):
    return (jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1]),
            jnp.where(c, a[2], b[2]))


def normalize3(a, eps=0.0):
    n2 = dot3(a, a)
    if eps:
        n2 = jnp.maximum(n2, eps * eps)
    inv = jax.lax.rsqrt(n2)
    return scale3(a, inv)


def create_horizontal3(v):
    """Componentized CreateHorizontal (Vec4D.cs:33-43): cross with ẑ,
    fallback x̂ when degenerate."""
    cx, cy = v[1], -v[0]  # v × (0,0,1) = (vy, -vx, 0)
    sq = cx * cx + cy * cy
    tiny = jnp.asarray(np.finfo(jnp.result_type(sq)).tiny, sq.dtype)
    good = sq > tiny
    inv = jax.lax.rsqrt(jnp.where(good, sq, 1.0))
    return (jnp.where(good, cx * inv, 1.0),
            jnp.where(good, cy * inv, 0.0),
            jnp.zeros_like(cx))


def rotate_about_axis3(vec, axis, theta):
    """Componentized Rodrigues rotation."""
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    kxv = cross3(axis, vec)
    kd = dot3(axis, vec) * (1.0 - ct)
    return (vec[0] * ct + kxv[0] * st + axis[0] * kd,
            vec[1] * ct + kxv[1] * st + axis[1] * kd,
            vec[2] * ct + kxv[2] * st + axis[2] * kd)


def create_horizon3(pole, z, theta):
    """Componentized CreateHorizon (Vec4D.cs:52-58)."""
    horiz = create_horizontal3(pole)
    s = safe_sqrt(1.0 - z * z)
    base = (pole[0] * z + horiz[0] * s,
            pole[1] * z + horiz[1] * s,
            pole[2] * z + horiz[2] * s)
    return rotate_about_axis3(base, pole, theta)


def rotate_about_axis3_cs(vec, axis, ct, st):
    """Componentized Rodrigues rotation with precomputed cos/sin(theta).

    The sampling path precomputes the azimuth trig outside the hot loop /
    kernel (transcendentals are pure functions of the uniforms), so the
    rotation itself is FMA-only.
    """
    kxv = cross3(axis, vec)
    kd = dot3(axis, vec) * (1.0 - ct)
    return (vec[0] * ct + kxv[0] * st + axis[0] * kd,
            vec[1] * ct + kxv[1] * st + axis[1] * kd,
            vec[2] * ct + kxv[2] * st + axis[2] * kd)


def create_horizon3_cs(pole, z, ct, st):
    """Componentized CreateHorizon (Vec4D.cs:52-58) with precomputed
    cos/sin of the azimuth angle."""
    horiz = create_horizontal3(pole)
    s = safe_sqrt(1.0 - z * z)
    base = (pole[0] * z + horiz[0] * s,
            pole[1] * z + horiz[1] * s,
            pole[2] * z + horiz[2] * s)
    return rotate_about_axis3_cs(base, pole, ct, st)


def create_horizon_cs(pole, z, ct, st):
    """[..., 3]-shaped CreateHorizon with precomputed azimuth cos/sin."""
    x, y, zc = unstack3(pole)
    out = create_horizon3_cs((x, y, zc), z, ct, st)
    return stack3(*out)


def reflect3(normal, incoming, cos):
    """Componentized Reflection (Raytracer.cs:58-61)."""
    k = 2.0 * cos
    return (incoming[0] + normal[0] * k,
            incoming[1] + normal[1] * k,
            incoming[2] + normal[2] * k)


def transform_point(m, p):
    """Apply row-major 4x4 ``m`` to point(s) ``p`` with implicit w=1.

    ``m`` is ``[..., 4, 4]`` or ``[4, 4]``; ``p`` is ``[..., 3]``.
    Matches ``Mat4x4D * Vec4D`` (Mat4x4D.cs:151-168) for W=1.
    """
    xp = jnp if isinstance(p, jnp.ndarray) else np
    r = xp.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]
    return r


def transform_dir(m, d):
    """Apply 4x4 ``m`` to direction(s) ``d`` with implicit w=0."""
    xp = jnp if isinstance(d, jnp.ndarray) else np
    return xp.einsum("...ij,...j->...i", m[..., :3, :3], d)
