"""Intersection-layer tests: analytic cases matching the reference's scalar
formulas (Triangle.cs:148-207, Sphere.cs:175-209, Plane.cs:36-66,
Primitive.cs:46-75)."""

import jax.numpy as jnp
import numpy as np

import jax

from raytracercore.intersect import HitRecord, jnp_ref
from raytracercore.intersect import closest_hit as _closest_hit

# Compile once per scene structure — eager dispatch of the many small ops in
# closest_hit is ~10s/call on CPU.
closest_hit = jax.jit(_closest_hit)
from raytracercore.scene import loader, types
from raytracercore.scene.types import (HostPlane, HostScene, HostSphere,
                                       HostTriangle, freeze_scene)


def make_scene(prims, **kwargs):
    scene = HostScene(width=4, height=4, **kwargs)
    for p in prims:
        scene.add_primitive(p)
    return freeze_scene(scene)


def rays(*pairs):
    o = jnp.array([p[0] for p in pairs], dtype=jnp.float32)
    d = jnp.array([p[1] for p in pairs], dtype=jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_triangle_basic_hit_miss():
    tri = HostTriangle(v0=np.array([0.0, 0, 0]), v1=np.array([1.0, 0, 0]),
                       v2=np.array([0.0, 1, 0]))
    tri.material.two_sided = True
    arr = make_scene([tri])
    o, d = rays(
        ([0.2, 0.2, -1.0], [0, 0, 1.0]),   # along +z = along the normal →
        #   approaches the -z face ⇒ backface hit (inside)
        ([0.9, 0.9, -1.0], [0, 0, 1.0]),   # outside u+v>1 → miss
        ([0.2, 0.2, 1.0], [0, 0, -1.0]),   # against the normal → front hit
        ([0.2, 0.2, -1.0], [0, 0, -1.0]),  # behind → miss
    )
    hit = closest_hit(arr, o, d, None)
    np.testing.assert_array_equal(np.asarray(hit.found),
                                  [True, False, True, False])
    assert abs(float(hit.t[0]) - 1.0) < 1e-5
    # Face normal e1×e2 = ẑ; backface hit flips it to -z and flags inside.
    assert bool(hit.inside[0])
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1],
                               atol=1e-6)
    # Front hit keeps +z and inside=False.
    assert not bool(hit.inside[2])
    np.testing.assert_allclose(np.asarray(hit.normal[2]), [0, 0, 1],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(hit.position[0]), [0.2, 0.2, 0],
                               atol=1e-6)


def test_triangle_mirror_quad():
    quad = HostTriangle(v0=np.array([0.0, 0, 0]), v1=np.array([1.0, 0, 0]),
                        v2=np.array([0.0, 1, 0]), mirror=True)
    quad.material.two_sided = True
    arr = make_scene([quad])
    o, d = rays(
        ([0.9, 0.9, -1.0], [0, 0, 1.0]),   # u+v > 1 but quad → hit
        ([1.1, 0.5, -1.0], [0, 0, 1.0]),   # u > 1 → miss
    )
    hit = closest_hit(arr, o, d, None)
    np.testing.assert_array_equal(np.asarray(hit.found), [True, False])


def test_single_sided_culls_inside():
    tri = HostTriangle(v0=np.array([0.0, 0, 0]), v1=np.array([1.0, 0, 0]),
                       v2=np.array([0.0, 1, 0]))
    tri.material.two_sided = False
    arr = make_scene([tri])
    o, d = rays(
        ([0.2, 0.2, -1.0], [0, 0, 1.0]),  # backface (inside) → culled
        ([0.2, 0.2, 1.0], [0, 0, -1.0]),  # front → kept
    )
    hit = closest_hit(arr, o, d, None)
    assert not bool(hit.found[0])
    assert bool(hit.found[1])


def test_invert_flips_inside():
    tri = HostTriangle(v0=np.array([0.0, 0, 0]), v1=np.array([1.0, 0, 0]),
                       v2=np.array([0.0, 1, 0]))
    tri.material.two_sided = False
    tri.material.invert = True
    arr = make_scene([tri])
    o, d = rays(
        ([0.2, 0.2, -1.0], [0, 0, 1.0]),  # geometric backface → inverted
        #   to inside=False → kept
        ([0.2, 0.2, 1.0], [0, 0, -1.0]),  # geometric front → inverted to
        #   inside=True → culled (single-sided)
    )
    hit = closest_hit(arr, o, d, None)
    assert bool(hit.found[0]) and not bool(hit.inside[0])
    # Normal stays the geometric (already flipped) normal — Hit.Inverted
    # flips only the flag (Hit.cs:39-42).
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1],
                               atol=1e-6)
    assert not bool(hit.found[1])


def test_sphere_two_roots_and_inside():
    sph = HostSphere(center=np.array([0.0, 0, 0]), radius=1.0)
    sph.material.two_sided = True
    arr = make_scene([sph])
    o, d = rays(
        ([0.0, 0, -3.0], [0, 0, 1.0]),  # outside → near root t=2
        ([0.0, 0, 0.0], [0, 0, 1.0]),   # at center → far root t=1, inside
        ([0.0, 3, -3.0], [0, 0, 1.0]),  # miss
    )
    hit = closest_hit(arr, o, d, None)
    np.testing.assert_array_equal(np.asarray(hit.found),
                                  [True, True, False])
    assert abs(float(hit.t[0]) - 2.0) < 1e-5
    assert not bool(hit.inside[0])
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1],
                               atol=1e-5)
    assert abs(float(hit.t[1]) - 1.0) < 1e-5
    assert bool(hit.inside[1])
    # Inside hit: normal negated → points back toward center.
    np.testing.assert_allclose(np.asarray(hit.normal[1]), [0, 0, -1],
                               atol=1e-5)


def test_ellipsoid_transformed():
    # scale(2,1,1) about origin: unit sphere → ellipsoid with x-radius 2.
    sph = HostSphere(center=np.array([0.0, 0, 0]), radius=1.0)
    sph.material.two_sided = True
    import raytracercore.scene.transforms as T
    sph.transform(T.scale(2, 1, 1), T.scale(0.5, 1, 1))
    arr = make_scene([sph])
    o, d = rays(
        ([-5.0, 0, 0], [1.0, 0, 0]),  # hits at x=-2 → t=3
        ([0.0, -5.0, 0], [0, 1.0, 0]),  # hits at y=-1 → t=4
        ([0.0, 0, -5.0], [0, 0, 1.0]),  # hits at z=-1 → t=4
    )
    hit = closest_hit(arr, o, d, None)
    assert np.asarray(hit.found).all()
    np.testing.assert_allclose(np.asarray(hit.t), [3.0, 4.0, 4.0], atol=1e-4)
    np.testing.assert_allclose(np.asarray(hit.position[0]), [-2, 0, 0],
                               atol=1e-4)
    # Normal on the ellipsoid at (-2,0,0) is -x̂.
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [-1, 0, 0],
                               atol=1e-4)


def test_plane_hit_and_inside():
    pl = HostPlane(normal=np.array([0.0, 0, 1.0]), origin_distance=2.0)
    pl.material.two_sided = True
    arr = make_scene([pl])
    o, d = rays(
        ([0.0, 0, 0.0], [0, 0, 1.0]),   # toward plane z=2, along normal
        ([0.0, 0, 5.0], [0, 0, -1.0]),  # from above, against normal
        ([0.0, 0, 5.0], [0, 0, 1.0]),   # away → miss
    )
    hit = closest_hit(arr, o, d, None)
    np.testing.assert_array_equal(np.asarray(hit.found),
                                  [True, True, False])
    assert abs(float(hit.t[0]) - 2.0) < 1e-5
    # Ray along normal ⇒ inside, normal flipped to -z.
    assert bool(hit.inside[0])
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1],
                               atol=1e-6)
    assert not bool(hit.inside[1])


def test_closest_across_tables():
    tri = HostTriangle(v0=np.array([-1.0, -1, 5]), v1=np.array([1.0, -1, 5]),
                       v2=np.array([-1.0, 1, 5]), mirror=True)
    sph = HostSphere(center=np.array([0.0, 0, 3.0]), radius=1.0)
    for p in (tri, sph):
        p.material.two_sided = True
    arr = make_scene([tri, sph])
    o, d = rays(([0.0, 0, 0.0], [0, 0, 1.0]))
    hit = closest_hit(arr, o, d, None)
    # Sphere near face at z=2 wins over triangle at z=5.
    assert int(hit.prim[0]) == 1
    assert abs(float(hit.t[0]) - 2.0) < 1e-5


def test_skip_hit_prevents_reintersection():
    sph = HostSphere(center=np.array([0.0, 0, 0]), radius=1.0)
    sph.material.two_sided = True
    arr = make_scene([sph])
    # A transmission-style ray whose origin sits a hair OUTSIDE the surface
    # (the fp situation skip-hits exist for; with the origin exactly on the
    # sphere the `radix < b` check already drops the near root,
    # Sphere.cs:199).
    z0 = -1.0 - 3e-5
    o = jnp.array([[0.0, 0, z0]], dtype=jnp.float32)
    d = jnp.array([[0.0, 0, 1.0]], dtype=jnp.float32)
    skip = HitRecord(
        prim=jnp.array([0], jnp.int32),
        t=jnp.array([0.0]),
        position=jnp.array([[0.0, 0, z0]]),
        normal=jnp.array([[0.0, 0, -1.0]]),  # outward normal at entry
        inside=jnp.array([False]))
    hit = closest_hit(arr, o, d, skip)
    # Without skip the near root at t≈3e-5 wins; with skip the exit hit at
    # t≈2 must be returned, flagged inside.
    assert bool(hit.found[0])
    assert abs(float(hit.t[0]) - 2.0) < 1e-3
    assert bool(hit.inside[0])

    hit_noskip = closest_hit(arr, o, d, None)
    assert abs(float(hit_noskip.t[0])) < 1e-3
    assert not bool(hit_noskip.inside[0])


def test_skip_requires_same_primitive():
    s0 = HostSphere(center=np.array([0.0, 0, 0]), radius=1.0)
    s1 = HostSphere(center=np.array([0.0, 0, 4.0]), radius=1.0)
    for p in (s0, s1):
        p.material.two_sided = True
    arr = make_scene([s0, s1])
    z0 = -1.0 - 3e-5  # slightly outside so the near root exists
    o = jnp.array([[0.0, 0, z0]], dtype=jnp.float32)
    d = jnp.array([[0.0, 0, 1.0]], dtype=jnp.float32)
    skip = HitRecord(
        prim=jnp.array([1], jnp.int32),  # different primitive
        t=jnp.array([0.0]),
        position=jnp.array([[0.0, 0, z0]]),
        normal=jnp.array([[0.0, 0, -1.0]]),
        inside=jnp.array([False]))
    hit = closest_hit(arr, o, d, skip)
    assert abs(float(hit.t[0])) < 1e-3  # near root NOT skipped


def test_bounce_scene_first_hits(bounce_txt):
    """Primary rays from inside the Cornell box must hit the room walls."""
    scene = loader.parse(bounce_txt)
    arr = freeze_scene(scene)
    # NOTE: (0,0,-1) would sit exactly ON the mirror sphere (center
    # (0,0,-.5), r=.5) — probe from an empty corner instead.
    o, d = rays(
        ([1.5, 1.5, -1.0], [0, 0, 1.0]),    # toward floor (z instance)
        ([1.5, 1.5, -1.0], [0, 0, -1.0]),   # toward ceiling (-z instance)
        ([1.5, 1.5, -1.0], [1.0, 0, 0.0]),  # toward x=+2 wall (x instance)
    )
    hit = closest_hit(arr, o, d, None)
    assert np.asarray(hit.found).all()
    # Room cube center (0,0,-1), size (4,4,2) → z∈[-2,0], x∈[-2,2].
    np.testing.assert_allclose(float(hit.t[0]), 1.0, atol=1e-4)
    np.testing.assert_allclose(float(hit.t[1]), 1.0, atol=1e-4)
    np.testing.assert_allclose(float(hit.t[2]), 0.5, atol=1e-4)
    # All are inverted room walls → inside flag cleared by Invert.
    assert not np.asarray(hit.inside).any()
    # Prim ids: instances are prims 5..10 in file order (-y,y,x,-x,-z,z).
    np.testing.assert_array_equal(np.asarray(hit.prim), [10, 9, 7])


def test_aabb_slab():
    bmin = jnp.array([[0.0, 0, 0]])
    bmax = jnp.array([[1.0, 1, 1]])
    o, d = rays(
        ([0.5, 0.5, -1.0], [0, 0, 1.0]),
        ([2.0, 0.5, -1.0], [0, 0, 1.0]),
        ([0.5, 0.5, 0.5], [0, 0, 1.0]),  # inside
        ([0.5, 0.5, -1.0], [0, 1.0, 0.0]),  # parallel, outside slab → miss
    )
    near, far = jnp_ref.aabb_slab(bmin, bmax, o, d)
    hit = near <= far
    np.testing.assert_array_equal(np.asarray(hit[:, 0]),
                                  [True, False, True, False])
    assert abs(float(near[0, 0]) - 1.0) < 1e-6
    assert abs(float(far[0, 0]) - 2.0) < 1e-6
    assert float(near[2, 0]) <= 0 and abs(float(far[2, 0]) - 0.5) < 1e-6
