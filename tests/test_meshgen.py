"""Procedural mesh scenes (scene/meshgen.py) — the at-scale config's
geometry path: icosphere tessellation, direct-to-SoA scene assembly, and
BVH-vs-dense agreement on the generated soup."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracercore.bvh.builder import build_triangle_bvh
from raytracercore.intersect.dispatch import (closest_hit,
                                              make_bvh_closest_fn)
from raytracercore.render import camera as cam_mod
from raytracercore.render.film import Film
from raytracercore.render.renderer import render_passes
from raytracercore.scene.meshgen import icosphere, make_mesh_scene
from raytracercore.scene.types import init_camera


def test_icosphere_counts_and_unit_verts():
    v, f = icosphere(2)
    assert f.shape == (20 * 4 ** 2, 3)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-12)


def test_mesh_scene_counts():
    arrays, cam, (v0, e1, e2, mirror, valid) = make_mesh_scene(
        grid=2, subdiv=1, width=32, height=32)
    expect = 2 * 2 * 80 + 2  # grid^2 * 20*4^subdiv + floor + light
    assert arrays.triangles.v0.shape[0] == expect
    assert v0.shape[0] == expect
    assert bool(mirror[-1]) and bool(mirror[-2])  # floor+light quads
    # Light is the only emitter.
    em = np.asarray(arrays.materials.emission)
    assert (em[:-1] == 0).all() and em[-1].min() > 0


def test_mesh_scene_bvh_matches_dense_and_renders():
    arrays, host_cam, (v0, e1, e2, mirror, valid) = make_mesh_scene(
        grid=2, subdiv=1, width=32, height=32, recursion=2)
    bvh = build_triangle_bvh(v0, e1, e2, mirror, valid, backend="numpy")
    closest = make_bvh_closest_fn(bvh)
    camera = init_camera(host_cam, 32, 32)
    px, py = cam_mod.pixel_grid(32, 32)
    o, d = cam_mod.center_rays(camera, px, py)
    hb = jax.jit(closest)(arrays, o, d, None)
    hd = jax.jit(closest_hit)(arrays, o, d, None)
    np.testing.assert_array_equal(np.asarray(hb.prim), np.asarray(hd.prim))

    film = render_passes(arrays, camera, Film.create(32, 32),
                         jax.random.PRNGKey(0), jnp.int32(0), n=2,
                         closest_fn=closest)
    img = np.asarray(film.color_sum)
    assert np.isfinite(img).all()
    assert img.max() > 0.1  # the light illuminates the field
