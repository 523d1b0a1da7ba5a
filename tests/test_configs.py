"""Scaled-down versions of the five BASELINE.json benchmark configs,
exercising each capability end-to-end on CPU (the real-size runs happen on
the GPU via chip_smoke.py and bench.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raytracercore.bvh import build_bvh
from raytracercore.diff import get_material_params, with_material_params
from raytracercore.intersect.dispatch import make_bvh_closest_fn
from raytracercore.parallel import (make_mesh, make_sharded_render_pass,
                                    make_train_step, place_film,
                                    place_scene)
from raytracercore.parallel.mesh import ray_sharded
from raytracercore.render import Renderer, trace
from raytracercore.render.film import Film
from raytracercore.render.integrator import BounceType
from raytracercore.scene import loader
from raytracercore.scene.types import (HostCamera, HostPlane, HostScene,
                                       HostSphere, HostTriangle,
                                       freeze_scene, init_camera)


def test_config1_cornell_diffuse_emission(bounce_txt):
    """Config 1: bounce.txt Cornell box, diffuse+emission only."""
    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 32
    # Strip speculars so only diffuse+emission paths remain.
    for p in scene.primitives:
        p.material.specular = np.zeros(3)
        p.material.refraction = np.zeros(3)
    r = Renderer(scene, seed=1)
    r.step(4)
    img = r.image()
    assert img[..., :3].max() > 50
    assert np.isfinite(np.asarray(r.film.color_sum)).all()


def test_config2_lens_fresnel_tir(bounce_txt):
    """Config 2: the glass lens — transmission, Fresnel ratio recorded,
    refraction branch actually taken."""
    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 16
    arrays = freeze_scene(scene)
    cam = init_camera(scene.cameras[1], 16, 16)
    # Aim rays straight at the lens sphere (center (1,-1.25,-.5)).
    n = 256
    o = jnp.tile(jnp.array([[1.0, -1.25, -2.5]], jnp.float32), (n, 1))
    jitter = 0.05 * jax.random.normal(jax.random.PRNGKey(0), (n, 2))
    d = jnp.concatenate([jitter, jnp.ones((n, 1))], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    color, miss, rec = jax.jit(
        lambda a, o, d, k: trace(a, o, d, k, record=True))(
            arrays, o, d, jax.random.PRNGKey(2))
    btypes = np.asarray(rec.btype)
    fres = np.asarray(rec.fresnel)
    assert (btypes == BounceType.TRANSMITTED).any(), "no transmission paths"
    # Fresnel ratios recorded on refractive interactions, within [0, 1].
    evaluated = np.isfinite(fres)
    assert evaluated.any()
    assert (fres[evaluated] >= 0).all() and (fres[evaluated] <= 1).all()
    assert np.isfinite(np.asarray(color)).all()


def test_config3_die_bvh(die_txt):
    """Config 3: die.txt through the BVH accelerator, DoF active."""
    scene = loader.parse(die_txt)
    scene.width = scene.height = 24
    scene.recursion = 4
    r = Renderer(scene, accelerator="bvh", seed=2)
    assert hasattr(r, "bvh")
    r.step(4)
    img = r.image()
    assert np.isfinite(np.asarray(r.film.color_sum)).all()
    assert img[..., :3].max() > 30  # lights visible
    # DoF is configured on the die cameras (dof .1 1000 to 3).
    assert float(r.camera.dof_amount) == 1000.0


def test_config4_mixed_stress_gradcheck():
    """Config 4: triangles+spheres+planes with glossy normal jitter, AD vs
    finite differences."""
    scene = HostScene(width=8, height=8, recursion=3)
    floor = HostPlane(normal=np.array([0.0, 0, 1.0]), origin_distance=-1.0)
    floor.material.two_sided = True
    floor.material.diffuse = np.array([0.4, 0.4, 0.5])
    quad = HostTriangle(v0=np.array([-2.0, -2, 3]), v1=np.array([2.0, -2, 3]),
                        v2=np.array([-2.0, 2, 3]), mirror=True)
    quad.material.two_sided = True
    quad.material.emission = np.array([4.0, 4, 4])
    ball = HostSphere(center=np.array([0.0, 0, 0.5]), radius=0.7)
    ball.material.two_sided = True
    ball.material.diffuse = np.array([0.3, 0.1, 0.1])
    ball.material.specular = np.array([0.5, 0.5, 0.5])
    ball.material.shininess = 64.0  # glossy → RandomShine jitter active
    for p in (floor, quad, ball):
        scene.add_primitive(p)
    arrays = freeze_scene(scene)

    n = 512
    o = jnp.tile(jnp.array([[0.0, -0.5, -3.0]], jnp.float32), (n, 1))
    xy = jax.random.uniform(jax.random.PRNGKey(1), (n, 2), minval=-0.3,
                            maxval=0.3)
    d = jnp.concatenate([xy, jnp.ones((n, 1))], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(9)

    def loss(p):
        color, _ = trace(with_material_params(arrays, p), o, d, key)
        return jnp.mean(color)

    loss_j = jax.jit(loss)
    g = jax.jit(jax.grad(loss))(get_material_params(arrays))
    params = get_material_params(arrays)
    eps = 2e-3
    for field, idx, chan in (("diffuse", 2, 0), ("specular", 2, 1),
                             ("emission", 1, 2), ("diffuse", 0, 2)):
        base = params[field]
        fd = (float(loss_j(dict(params,
                                **{field: base.at[idx, chan].add(eps)})))
              - float(loss_j(dict(params,
                                  **{field: base.at[idx, chan].add(-eps)}))
                      )) / (2 * eps)
        ad = float(np.asarray(g[field])[idx, chan])
        assert ad == pytest.approx(fd, rel=0.08, abs=3e-3), \
            f"{field}[{idx},{chan}] AD {ad} vs FD {fd}"


@pytest.mark.slow
def test_config5_large_mesh_sharded():
    """Config 5 (scaled): thousands of triangles, BVH built natively,
    sharded render + train step across the 8-device mesh."""
    rng = np.random.default_rng(0)
    scene = HostScene(width=16, height=16, recursion=2)
    light = HostTriangle(v0=np.array([-8.0, -8, 9]), v1=np.array([8.0, -8, 9]),
                         v2=np.array([-8.0, 8, 9]), mirror=True)
    light.material.two_sided = True
    light.material.emission = np.array([6.0, 6, 6])
    scene.add_primitive(light)
    scene.cameras.append(HostCamera(
        mode="frustum", position=np.array([0.0, 0, -6.0]),
        look_at=np.zeros(3), up=np.array([0.0, 1, 0]),
        fov_or_size=np.radians(60)))
    for _ in range(5000):
        base = rng.uniform(-4, 4, 3)
        tri = HostTriangle(v0=base, v1=base + rng.normal(0, 0.2, 3),
                           v2=base + rng.normal(0, 0.2, 3))
        tri.material.two_sided = True
        tri.material.diffuse = rng.uniform(0.2, 0.9, 3)
        scene.add_primitive(tri)

    bvh = build_bvh(scene)  # auto-selects the native builder at this size
    closest = make_bvh_closest_fn(bvh)
    arrays = freeze_scene(scene)
    mesh = make_mesh(n_rays=8)
    arrays_r = place_scene(mesh, arrays)
    cam = init_camera(scene.cameras[0], 16, 16)

    render = make_sharded_render_pass(mesh, closest_fn=closest)
    film = place_film(mesh, Film.create(16, 16))
    film = render(arrays_r, cam, film, jax.random.PRNGKey(0))
    assert np.isfinite(np.asarray(film.color_sum)).all()
    assert float(jnp.sum(film.samples)) > 0

    optimizer = optax.adam(1e-2)
    params = get_material_params(arrays_r)
    step = make_train_step(mesh, optimizer, closest_fn=closest)
    target = jax.device_put(jnp.zeros((16, 16, 3)), ray_sharded(mesh, 3))
    p1, _, loss = step(params, arrays_r, cam, target, optimizer.init(params),
                       jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))
