"""BVH tests: structural invariants of the builder, traversal equivalence
against the brute-force oracle, and gradients through the BVH path."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracercore.bvh import build_bvh, count_node_hits
from raytracercore.intersect import closest_hit
from raytracercore.intersect.dispatch import make_bvh_closest_fn
from raytracercore.scene import loader
from raytracercore.scene.types import HostScene, HostTriangle, freeze_scene


def random_tri_scene(n=64, seed=0, two_sided=True):
    rng = np.random.default_rng(seed)
    scene = HostScene(width=4, height=4)
    for i in range(n):
        base = rng.uniform(-4, 4, 3)
        tri = HostTriangle(v0=base,
                           v1=base + rng.normal(0, 0.7, 3),
                           v2=base + rng.normal(0, 0.7, 3),
                           mirror=bool(rng.integers(0, 2)))
        tri.material.two_sided = two_sided
        tri.material.diffuse = rng.uniform(0, 1, 3)
        scene.add_primitive(tri)
    return scene


def random_rays(n=256, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def test_builder_structure():
    scene = random_tri_scene(50)
    bvh = build_bvh(scene, leaf_size=4)
    n = bvh.n_nodes
    skip = np.asarray(bvh.skip)
    slot = np.asarray(bvh.leaf_slot)
    # Escape links are strictly forward and bounded.
    idx = np.arange(n)
    assert (skip > idx).all() and (skip <= n).all()
    # Every triangle appears exactly once across leaves.
    prims = np.asarray(bvh.leaf_prims)
    used = prims[prims >= 0]
    assert sorted(used.tolist()) == list(range(50))
    # Leaves have slots, internals don't.
    assert (slot >= 0).sum() == prims.shape[0]
    # Child boxes are contained in parent boxes (preorder: node i+1 is the
    # left child of internal i).
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)
    for i in range(n):
        if slot[i] < 0:  # internal
            j = i + 1
            assert (bmin[j] >= bmin[i] - 1e-5).all()
            assert (bmax[j] <= bmax[i] + 1e-5).all()


def test_traversal_matches_brute_force():
    scene = random_tri_scene(80, seed=3)
    arrays = freeze_scene(scene)
    bvh = build_bvh(scene)
    o, d = random_rays(512, seed=4)

    ref = jax.jit(closest_hit)(arrays, o, d, None)
    bvh_fn = make_bvh_closest_fn(bvh)
    got = jax.jit(bvh_fn)(arrays, o, d, None)

    np.testing.assert_array_equal(np.asarray(got.found),
                                  np.asarray(ref.found))
    m = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.prim)[m],
                                  np.asarray(ref.prim)[m])
    np.testing.assert_allclose(np.asarray(got.position)[m],
                               np.asarray(ref.position)[m], atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.normal)[m],
                               np.asarray(ref.normal)[m], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.inside)[m],
                                  np.asarray(ref.inside)[m])


def test_traversal_single_sided_and_skip():
    # Single-sided: traversal must not let a culled closer hit shadow a
    # farther valid one.
    scene = random_tri_scene(40, seed=7, two_sided=False)
    arrays = freeze_scene(scene)
    bvh = build_bvh(scene)
    o, d = random_rays(256, seed=8)
    ref = jax.jit(closest_hit)(arrays, o, d, None)
    got = jax.jit(make_bvh_closest_fn(bvh))(arrays, o, d, None)
    np.testing.assert_array_equal(np.asarray(got.prim),
                                  np.asarray(ref.prim))

    # Skip record equivalence: reuse the brute-force first hit as skip.
    skip = ref
    ref2 = jax.jit(closest_hit)(arrays, o, d, skip)
    got2 = jax.jit(make_bvh_closest_fn(bvh))(arrays, o, d, skip)
    np.testing.assert_array_equal(np.asarray(got2.prim),
                                  np.asarray(ref2.prim))


def test_bounce_scene_bvh_render_matches(bounce_txt):
    """Full integrator equivalence brute vs BVH on the Cornell box."""
    from raytracercore.render import trace

    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 24
    scene.recursion = 4
    arrays = freeze_scene(scene)
    bvh = build_bvh(scene)
    from raytracercore.render import camera as cm
    from raytracercore.scene.types import init_camera
    cam = init_camera(scene.cameras[0], 24, 24)
    px, py = cm.pixel_grid(24, 24)
    key = jax.random.PRNGKey(11)
    kc, kp = jax.random.split(key)
    o, d = cm.camera_rays(cam, px, py, kc)

    c_ref, m_ref = jax.jit(trace)(arrays, o, d, kp)
    bvh_fn = make_bvh_closest_fn(bvh)
    c_bvh, m_bvh = jax.jit(
        lambda a, o, d, k: trace(a, o, d, k, closest_fn=bvh_fn))(
            arrays, o, d, kp)
    np.testing.assert_array_equal(np.asarray(m_ref), np.asarray(m_bvh))
    np.testing.assert_allclose(np.asarray(c_ref), np.asarray(c_bvh),
                               rtol=1e-4, atol=1e-4)


def test_gradients_through_bvh_path(bounce_txt):
    from raytracercore.diff import (get_material_params,
                                    with_material_params)
    from raytracercore.render import trace

    scene = loader.parse(bounce_txt)
    scene.recursion = 3
    arrays = freeze_scene(scene)
    bvh = build_bvh(scene)
    bvh_fn = make_bvh_closest_fn(bvh)
    o = jnp.tile(jnp.array([[0.5, 0.5, -0.5]], jnp.float32), (64, 1))
    d = jax.random.normal(jax.random.PRNGKey(0), (64, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    def loss(p):
        color, _ = trace(with_material_params(arrays, p), o, d,
                         jax.random.PRNGKey(5), closest_fn=bvh_fn)
        return jnp.mean(color)

    g = jax.jit(jax.grad(loss))(get_material_params(arrays))
    for k, v in g.items():
        assert np.isfinite(np.asarray(v)).all(), k
    assert float(jnp.abs(g["emission"]).sum()) > 0


def test_count_node_hits():
    scene = random_tri_scene(30)
    bvh = build_bvh(scene)
    o, d = random_rays(64)
    counts = np.asarray(count_node_hits(bvh, o, d))
    assert counts.shape == (64,)
    assert (counts >= 0).all() and counts.max() <= bvh.n_nodes


def test_native_builder_matches_semantics():
    """The C++ builder produces a valid BVH whose traversal matches brute
    force (structure may differ from the numpy builder; the contract is the
    closest-hit result)."""
    from raytracercore.native import native_available
    if not native_available():
        import pytest
        pytest.skip("native builder unavailable")

    from raytracercore.bvh.builder import build_triangle_bvh
    scene = random_tri_scene(120, seed=12)
    arrays = freeze_scene(scene)
    tris = scene.triangles
    v0 = np.stack([t.v0 for t in tris])
    e1 = np.stack([t.edge01 for t in tris])
    e2 = np.stack([t.edge02 for t in tris])
    mirror = np.array([t.mirror for t in tris], bool)
    bvh = build_triangle_bvh(v0, e1, e2, mirror, np.ones(len(tris), bool),
                             backend="native")
    # Structural invariants.
    skip = np.asarray(bvh.skip)
    idx = np.arange(len(skip))
    assert (skip > idx).all() and (skip <= len(skip)).all()
    prims = np.asarray(bvh.leaf_prims)
    used = prims[prims >= 0]
    assert sorted(used.tolist()) == list(range(120))
    # Traversal equivalence.
    o, d = random_rays(256, seed=13)
    ref = jax.jit(closest_hit)(arrays, o, d, None)
    got = jax.jit(make_bvh_closest_fn(bvh))(arrays, o, d, None)
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    m = np.asarray(ref.found)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-5)
