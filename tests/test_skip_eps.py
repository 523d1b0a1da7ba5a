"""Probing the skip-hit position epsilon (dispatch._position_eps).

The reference compares hit records essentially exactly in f64
(Util.RayHitMatches + NearlyEqual, Util.cs:18,41-74,179-192); the f32
rebuild uses a relative tolerance because hit positions are recomputed
through different formulas between bounces.  These tests pin the two
failure modes the tolerance trades off (round-1 VERDICT "what's weak"):

* same-point re-hit at a grazing angle must BE skipped (else the bounce
  loop self-intersects and the image speckles);
* a legitimately close SECOND surface (thin geometry) must NOT be skipped
  once it is farther than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np

from raytracercore.intersect.dispatch import (_position_eps, closest_hit)
from raytracercore.scene import loader


def _scene_two_walls(gap: float) -> str:
    # Two parallel one-sided quads facing +z, separated by `gap` along z.
    return f"""
size 8 8
camera 0 0 5  0 0 0  0 1 0  60
diffuse .5 .5 .5
vertex -1 -1 0
vertex  1 -1 0
vertex -1  1 0
tri 0 1 2 mirrored
vertex -1 -1 {-gap}
vertex  1 -1 {-gap}
vertex -1  1 {-gap}
tri 3 4 5 mirrored
"""


def _hit_then_rehit(gap: float):
    """Primary hit on wall A, then re-cast the SAME ray from the hit point
    with A as skip: the result should be wall B (prim 1), not A."""
    from raytracercore.scene.types import freeze_scene

    scene = loader.parse(_scene_two_walls(gap))
    arrays = freeze_scene(scene)
    o = jnp.asarray([[0.3, 0.2, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    first = jax.jit(closest_hit)(arrays, o, d, None)
    assert int(first.prim[0]) == 0
    second = jax.jit(closest_hit)(arrays, first.position, d, first)
    return first, second


def test_skip_does_not_mask_thin_geometry():
    # Wall B sits well beyond the tolerance: it must be found.
    eps = _position_eps(jnp.float32)
    gap = 100 * eps  # 1e-2: thin but resolvable in f32
    _, second = _hit_then_rehit(gap)
    assert int(second.prim[0]) == 1
    np.testing.assert_allclose(float(second.t[0]), gap, rtol=1e-2)


def test_skip_blocks_same_point_rehit():
    # With a huge gap the only nearby candidate is the skip surface itself;
    # the re-cast must not re-hit A at t≈0.
    _, second = _hit_then_rehit(gap=5.0)
    assert int(second.prim[0]) == 1
    assert float(second.t[0]) > 1.0


def test_skip_grazing_angle_rehit():
    """A bounce ray leaving at a grazing angle along wall A must not re-hit
    the same point, and must eventually be free of A (one-sided wall: the
    grazing ray's later positions diverge from the skip point)."""
    from raytracercore.scene.types import freeze_scene

    scene = loader.parse(_scene_two_walls(5.0))
    arrays = freeze_scene(scene)
    o = jnp.asarray([[0.3, 0.2, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    first = jax.jit(closest_hit)(arrays, o, d, None)
    # Graze: 89.4 degrees off the normal, sliding along +x.
    graze = jnp.asarray([[0.995, 0.0, -0.1]], jnp.float32)
    graze = graze / jnp.linalg.norm(graze)
    second = jax.jit(closest_hit)(arrays, first.position, graze, first)
    # The grazing ray re-enters wall A's plane ~7 units along +x — outside
    # the quad (u>1), so the correct answer is wall B or a miss; what it
    # must NOT be is the same point at t≈0.
    if int(second.prim[0]) == 0:
        assert float(second.t[0]) > 1e-2
