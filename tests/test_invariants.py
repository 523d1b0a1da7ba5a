"""Property tests for the reference's TRACE-assertion set (SURVEY §4/§5.2).

The reference has no unit tests; its quality bar is ~30 `Util.Assert` calls
compiled under TRACE (Util.cs:76-106).  This file turns each invariant into a
fixed-fuzz property test over random rays/scenes:

* unit-length ray directions            (Ray.cs:37-39)
* hit distance/position consistency     (Triangle.cs:195-198)
* non-NaN AABBs / BVH validity          (AABB.cs:58-63, BVH.cs:412-424)
* NaN-free trace outputs under fuzz     (the integrator's NaN-hardening)
* gradient finiteness under fuzz        (no reference analog — AD invariant)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracercore.bvh.builder import build_triangle_bvh, triangle_bounds
from raytracercore.core import vecmath as vm
from raytracercore.intersect.dispatch import closest_hit
from raytracercore.render import camera as cam_mod
from raytracercore.render.integrator import trace
from raytracercore.scene import loader
from raytracercore.scene.types import freeze_scene, init_camera

N_FUZZ = 512


@pytest.fixture(scope="module")
def bounce(request):
    scene = loader.parse(request.getfixturevalue("bounce_txt"))
    scene.width = scene.height = 24
    scene.recursion = 6
    return scene


def _fuzz_rays(key, n, scale=6.0):
    ko, kd = jax.random.split(key)
    o = jax.random.uniform(ko, (n, 3), minval=-scale, maxval=scale)
    d = jax.random.normal(kd, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_camera_rays_unit_direction(bounce):
    """Ray.ctor asserts |direction| == 1 (Ray.cs:37-39)."""
    cam = init_camera(bounce.cameras[0], 24, 24)
    px, py = cam_mod.pixel_grid(24, 24)
    _, d = cam_mod.camera_rays(cam, px, py, jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               atol=1e-6)


def test_hit_distance_position_consistency(bounce):
    """Triangle.DoRayTrace asserts t ≈ |hit − origin| and
    hit ≈ origin + t·d (Triangle.cs:195-198) — here for every table via the
    dispatch winner evaluation."""
    arrays = freeze_scene(bounce)
    o, d = _fuzz_rays(jax.random.PRNGKey(1), N_FUZZ, scale=2.5)
    hit = jax.jit(closest_hit)(arrays, o, d, None)
    f = np.asarray(hit.found)
    t = np.asarray(hit.t)[f]
    pos = np.asarray(hit.position)[f]
    on = np.asarray(o)[f]
    dn = np.asarray(d)[f]
    assert f.sum() > 50  # fuzz actually hits the scene
    np.testing.assert_allclose(np.linalg.norm(pos - on, axis=-1), t,
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(on + dn * t[:, None], pos, atol=5e-3)


def test_hit_normals_unit_and_finite(bounce):
    arrays = freeze_scene(bounce)
    o, d = _fuzz_rays(jax.random.PRNGKey(2), N_FUZZ, scale=2.5)
    hit = jax.jit(closest_hit)(arrays, o, d, None)
    f = np.asarray(hit.found)
    n = np.asarray(hit.normal)[f]
    assert np.isfinite(n).all()
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-4)


def _random_soup(key, n_tris):
    kv, ke = jax.random.split(key)
    v0 = np.asarray(jax.random.uniform(kv, (n_tris, 3), minval=-4,
                                       maxval=4))
    e = np.asarray(jax.random.normal(ke, (n_tris, 2, 3)))
    return v0, e[:, 0], e[:, 1]


@pytest.mark.parametrize("n_tris", [7, 300])
def test_bvh_validity(n_tris):
    """BVH structural invariants (the reference asserts uniqueness during
    Flatten, BVH.cs:412-424; AABB non-NaN at AABB.cs:58-63):

    * every node AABB is finite and min ≤ max
    * skip links land strictly forward (preorder escape indices)
    * leaves partition the input exactly once
    * each leaf's primitives' bounds are inside the leaf AABB
    * each internal node's AABB contains its subtree's AABBs
    """
    v0, e1, e2 = _random_soup(jax.random.PRNGKey(n_tris), n_tris)
    mirror = np.zeros(n_tris, bool)
    valid = np.ones(n_tris, bool)
    bvh = build_triangle_bvh(v0, e1, e2, mirror, valid, leaf_size=4,
                             backend="numpy")
    bmin, bmax = np.asarray(bvh.bmin), np.asarray(bvh.bmax)
    skip = np.asarray(bvh.skip)
    slot = np.asarray(bvh.leaf_slot)
    leaf_prims = np.asarray(bvh.leaf_prims)
    n = bvh.n_nodes

    assert np.isfinite(bmin).all() and np.isfinite(bmax).all()
    assert (bmin <= bmax + 1e-6).all()
    idx = np.arange(n)
    assert (skip > idx).all() and (skip <= n).all()

    seen = leaf_prims[leaf_prims >= 0]
    assert sorted(seen.tolist()) == list(range(n_tris))

    tb_min, tb_max = triangle_bounds(v0, e1, e2, mirror)
    for i in range(n):
        if slot[i] >= 0:
            prims = leaf_prims[slot[i]]
            prims = prims[prims >= 0]
            assert (tb_min[prims] >= bmin[i] - 1e-5).all()
            assert (tb_max[prims] <= bmax[i] + 1e-5).all()
        else:
            # Children = nodes (i, skip[i]); subtree containment.
            sub = np.arange(i + 1, skip[i])
            assert len(sub) >= 2
            assert (bmin[sub] >= bmin[i][None] - 1e-5).all()
            assert (bmax[sub] <= bmax[i][None] + 1e-5).all()


def test_trace_nan_free_under_fuzz(bounce):
    """The integrator's NaN-hardening: fuzzed secondary-style rays (origins
    inside the scene, arbitrary directions) must never produce NaN/Inf
    colors — the batched analog of the reference's NaN guards
    (Vec4D.WithDefault, Vec4D.cs:367; DoubleColor unclamped linear RGB)."""
    arrays = freeze_scene(bounce)
    o, d = _fuzz_rays(jax.random.PRNGKey(3), N_FUZZ, scale=3.0)
    color, miss = jax.jit(trace)(arrays, o, d, jax.random.PRNGKey(9))
    assert np.isfinite(np.asarray(color)).all()
    assert np.asarray(miss).dtype == bool


def test_gradients_finite_under_fuzz(bounce):
    """Material gradients of fuzzed traces stay finite (the masked-Fresnel
    NaN hardening of integrator.trace under reverse AD)."""
    from raytracercore.diff import (get_material_params,
                                    with_material_params)
    arrays = freeze_scene(bounce)
    o, d = _fuzz_rays(jax.random.PRNGKey(4), 128, scale=3.0)
    params = get_material_params(arrays)

    def loss(p):
        s = with_material_params(arrays, p)
        color, _ = trace(s, o, d, jax.random.PRNGKey(10))
        return jnp.sum(color)

    grads = jax.jit(jax.grad(loss))(params)
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), k


def test_debug_nans_clean_small_trace(bounce):
    """jax_debug_nans over a full trace: no intermediate op may produce a
    NaN output (stricter than finite-final-color; SURVEY §5.2)."""
    arrays = freeze_scene(bounce)
    o, d = _fuzz_rays(jax.random.PRNGKey(5), 64, scale=3.0)
    with jax.debug_nans(True):
        color, _ = trace(arrays, o, d, jax.random.PRNGKey(11))
        jax.block_until_ready(color)
    assert np.isfinite(np.asarray(color)).all()
