"""Differentiability tests: jax.grad of pixel values w.r.t. material
parameters must match finite differences of the same fixed-RNG estimator
(the BASELINE.json correctness gate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracercore.diff import get_material_params, with_material_params
from raytracercore.render import trace
from raytracercore.scene import loader
from raytracercore.scene.types import (HostScene, HostSphere,
                                       HostTriangle, freeze_scene)


def cornell_mini():
    """A small closed scene: emissive quad + diffuse sphere + floor."""
    scene = HostScene(width=8, height=8, recursion=3)
    light = HostTriangle(v0=np.array([-1.0, -1, 4]), v1=np.array([1.0, -1, 4]),
                         v2=np.array([-1.0, 1, 4]), mirror=True)
    light.material.two_sided = True
    light.material.emission = np.array([3.0, 3.0, 3.0])
    floor = HostTriangle(v0=np.array([-5.0, -5, -1]),
                         v1=np.array([5.0, -5, -1]),
                         v2=np.array([-5.0, 5, -1]), mirror=True)
    floor.material.two_sided = True
    floor.material.diffuse = np.array([0.6, 0.5, 0.4])
    ball = HostSphere(center=np.array([0.0, 0, 1.0]), radius=0.8)
    ball.material.two_sided = True
    ball.material.diffuse = np.array([0.7, 0.2, 0.2])
    ball.material.specular = np.array([0.2, 0.2, 0.2])
    ball.material.shininess = 50.0
    for p in (light, floor, ball):
        scene.add_primitive(p)
    return scene


def batch_rays(n=512, seed=0):
    k = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(k)
    o = jnp.tile(jnp.array([[0.0, 0.0, -3.0]], jnp.float32), (n, 1))
    # Fan of directions toward the scene.
    xy = jax.random.uniform(k1, (n, 2), minval=-0.4, maxval=0.4)
    d = jnp.concatenate([xy, jnp.ones((n, 1))], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("field,index", [
    ("emission", 0), ("diffuse", 1), ("diffuse", 2), ("specular", 2),
])
def test_grad_matches_finite_difference(field, index):
    scene = cornell_mini()
    arr = freeze_scene(scene)
    o, d = batch_rays()
    key = jax.random.PRNGKey(42)

    def loss(params):
        color, _ = trace(with_material_params(arr, params), o, d, key)
        return jnp.mean(color)

    loss = jax.jit(loss)
    grad_fn = jax.jit(jax.grad(loss))

    g = grad_fn(get_material_params(arr))
    g_field = np.asarray(g[field])

    # Central finite differences on the red channel of primitive `index`.
    eps = 2e-3
    params = get_material_params(arr)
    base = params[field]
    for chan in (0, 1):
        fd_p = dict(params, **{field: base.at[index, chan].add(eps)})
        fd_m = dict(params, **{field: base.at[index, chan].add(-eps)})
        fd = (float(loss(fd_p)) - float(loss(fd_m))) / (2 * eps)
        ad = float(g_field[index, chan])
        # f32 stochastic estimator: compare with mixed tolerance.
        assert ad == pytest.approx(fd, rel=0.05, abs=2e-3), (
            f"{field}[{index},{chan}]: AD {ad} vs FD {fd}")


def test_grad_nonzero_and_finite_on_bounce(bounce_txt):
    scene = loader.parse(bounce_txt)
    arr = freeze_scene(scene)
    o, d = batch_rays(256, seed=1)
    # Aim from inside the room toward the light box.
    o = jnp.tile(jnp.array([[0.5, 0.5, -0.5]], jnp.float32), (256, 1))
    d = jnp.concatenate([
        0.3 * jax.random.uniform(jax.random.PRNGKey(2), (256, 2),
                                 minval=-1, maxval=1),
        -jnp.ones((256, 1))], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    def loss(params):
        color, _ = trace(with_material_params(arr, params), o, d,
                         jax.random.PRNGKey(7))
        return jnp.mean(color)

    g = jax.jit(jax.grad(loss))(get_material_params(arr))
    g_em = np.asarray(g["emission"])
    g_df = np.asarray(g["diffuse"])
    assert np.isfinite(g_em).all() and np.isfinite(g_df).all()
    # The light box (prims 0..4) must receive emission gradient.
    assert np.abs(g_em[:5]).sum() > 0
