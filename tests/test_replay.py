"""Path-replay backward (render/replay.py): the fast train path must be the
SAME estimator as the full integrator — identical forward values, misses,
and material gradients — while its backward never re-runs selection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracercore.config import SCENES_DIR
from raytracercore.diff import get_material_params, with_material_params
from raytracercore.render.integrator import trace
from raytracercore.render.replay import trace_replay
from raytracercore.scene import loader
from raytracercore.scene.types import freeze_scene


def bounce_rays(n=256, seed=2):
    """Rays from inside the Cornell box toward the light wall — paths that
    exercise diffuse, specular, transmission and emission branches."""
    o = jnp.tile(jnp.array([[0.5, 0.5, -0.5]], jnp.float32), (n, 1))
    d = jnp.concatenate([
        0.6 * jax.random.uniform(jax.random.PRNGKey(seed), (n, 2),
                                 minval=-1, maxval=1),
        -jnp.ones((n, 1))], axis=-1)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def bounce_arrays(request):
    scene = loader.from_file(str(SCENES_DIR / "bounce.txt"))
    scene.width = scene.height = 16
    return freeze_scene(scene)


def test_replay_forward_matches_trace(bounce_arrays):
    """Same key ⇒ bitwise-equal colors and misses (both paths share the
    winner-eval code and the uniform schedule)."""
    o, d = bounce_rays()
    key = jax.random.PRNGKey(7)
    c1, m1 = jax.jit(lambda a: trace(a, o, d, key))(bounce_arrays)
    c2, m2 = jax.jit(lambda a: trace_replay(a, o, d, key))(bounce_arrays)
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=0, atol=0)


@pytest.mark.slow
def test_replay_grads_match_trace(bounce_arrays):
    """grad(trace_replay) == grad(trace): both differentiate the same
    fixed-decision estimator, so material gradients must agree."""
    o, d = bounce_rays(n=512, seed=3)
    key = jax.random.PRNGKey(11)
    params = get_material_params(bounce_arrays)

    def make_loss(fn):
        def L(p):
            color, _ = fn(with_material_params(bounce_arrays, p), o, d, key)
            return jnp.mean(color)
        return L

    g_ref = jax.jit(jax.grad(make_loss(trace)))(params)
    g_rep = jax.jit(jax.grad(make_loss(trace_replay)))(params)
    nonzero = 0
    for k in params:
        ref, rep = np.asarray(g_ref[k]), np.asarray(g_rep[k])
        assert np.isfinite(rep).all(), k
        np.testing.assert_allclose(rep, ref, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        nonzero += int((np.abs(ref) > 0).sum())
    assert nonzero > 10  # the comparison must not be vacuous


def test_replay_grad_matches_finite_difference(bounce_arrays):
    """End-to-end check against central finite differences of the replay
    estimator itself (the BASELINE.json gradient gate on the train path)."""
    o, d = bounce_rays(n=512, seed=4)
    key = jax.random.PRNGKey(5)
    params = get_material_params(bounce_arrays)

    def L(p):
        color, _ = trace_replay(with_material_params(bounce_arrays, p),
                                o, d, key)
        return jnp.mean(color)

    Lj = jax.jit(L)
    g = jax.jit(jax.grad(L))(params)
    eps = 2e-3
    checked = 0
    for field in ("emission", "diffuse"):
        ga = np.asarray(g[field])
        # Pick the largest-gradient entry so the FD signal is real.
        idx = np.unravel_index(np.abs(ga).argmax(), ga.shape)
        if abs(ga[idx]) == 0:
            continue
        base = params[field]
        fd_p = dict(params, **{field: base.at[idx].add(eps)})
        fd_m = dict(params, **{field: base.at[idx].add(-eps)})
        fd = (float(Lj(fd_p)) - float(Lj(fd_m))) / (2 * eps)
        assert ga[idx] == pytest.approx(fd, rel=0.05, abs=2e-3), field
        checked += 1
    assert checked == 2


def test_replay_with_bvh_closest_fn():
    """The recorder accepts any closest-hit implementation — BVH selection
    feeds the same tape/replay machinery."""
    rng = np.random.default_rng(0)
    from raytracercore.bvh import build_bvh
    from raytracercore.intersect.dispatch import make_bvh_closest_fn
    from raytracercore.scene.types import HostScene, HostTriangle

    scene = HostScene(width=8, height=8, recursion=3)
    for i in range(40):
        v0 = rng.uniform(-2, 2, 3)
        tri = HostTriangle(v0=v0, v1=v0 + rng.uniform(-.5, .5, 3),
                           v2=v0 + rng.uniform(-.5, .5, 3))
        tri.material.two_sided = True
        tri.material.diffuse = rng.uniform(0.2, 0.9, 3)
        tri.material.emission = rng.uniform(0, 0.5, 3)
        scene.add_primitive(tri)
    arrays = freeze_scene(scene)
    bvh = build_bvh(scene)
    bvh_fn = make_bvh_closest_fn(bvh)

    o = jnp.tile(jnp.array([[0.0, 0.0, -4.0]], jnp.float32), (128, 1))
    xy = jax.random.uniform(jax.random.PRNGKey(1), (128, 2),
                            minval=-0.5, maxval=0.5)
    d = jnp.concatenate([xy, jnp.ones((128, 1))], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(3)

    c1, m1 = trace(arrays, o, d, key, closest_fn=bvh_fn)
    c2, m2 = trace_replay(arrays, o, d, key, closest_fn=bvh_fn)
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=0, atol=0)


@pytest.mark.slow
def test_train_step_replay_matches_full_ad(bounce_arrays):
    """make_train_step(use_replay=True) computes the same loss and update
    as the full-AD step."""
    import optax

    from raytracercore.parallel.shard import make_train_step
    from raytracercore.scene.types import init_camera

    scene = loader.from_file(str(SCENES_DIR / "bounce.txt"))
    scene.width = scene.height = 8
    scene.recursion = 3
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], 8, 8)
    optimizer = optax.sgd(1e-2)
    params = get_material_params(arrays)
    opt_state = optimizer.init(params)
    target = jnp.zeros((8, 8, 3), jnp.float32)
    key = jax.random.PRNGKey(0)

    step_fast = make_train_step(None, optimizer, use_replay=True)
    step_slow = make_train_step(None, optimizer, use_replay=False)
    p1, _, l1 = step_fast(params, arrays, camera, target, opt_state, key)
    p2, _, l2 = step_slow(params, arrays, camera, target, opt_state, key)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_train_step_through_bvh_matches_dense():
    """A full optimization step (record -> replay -> grads -> adam) whose
    closest-hit runs through make_bvh_closest_fn must match the dense-scan
    step exactly (the BVH picks the same winners) — the at-scale training
    path, certified end to end."""
    import optax

    from raytracercore.bvh import build_bvh
    from raytracercore.intersect.dispatch import make_bvh_closest_fn
    from raytracercore.parallel.shard import make_train_step
    from raytracercore.scene import loader
    from raytracercore.scene.types import init_camera

    scene = loader.from_file(str(SCENES_DIR / "bounce.txt"))
    scene.width = scene.height = 16
    scene.recursion = 4
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], 16, 16)
    bvh = build_bvh(scene)
    bvh_fn = make_bvh_closest_fn(bvh)

    optimizer = optax.adam(1e-2)
    params = get_material_params(arrays)
    target = jnp.zeros((16, 16, 3), jnp.float32)
    key = jax.random.PRNGKey(5)

    s_dense = make_train_step(None, optimizer)
    s_bvh = make_train_step(None, optimizer, closest_fn=bvh_fn)
    p_d, _, loss_d = s_dense(params, arrays, camera, target,
                             optimizer.init(params), key)
    p_b, _, loss_b = s_bvh(params, arrays, camera, target,
                           optimizer.init(params), key)
    assert np.isfinite(float(loss_b))
    assert float(loss_b) == pytest.approx(float(loss_d), rel=1e-6)
    for k in p_d:
        np.testing.assert_allclose(np.asarray(p_b[k]), np.asarray(p_d[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("route", ["triton", "xla"])
def test_record_tape_follows_route(bounce_arrays, monkeypatch, route):
    """``record_tape`` records through the megakernel exactly when
    ``config.trace_route`` says "triton" (here with the kernel
    in the interpreter), and the replayed colors agree with ``trace``."""
    from raytracercore import config
    from raytracercore.render import fused

    calls = []
    real = fused.trace_fused

    def spy(*args, **kwargs):
        calls.append(kwargs.get("want_tape"))
        return real(*args, **dict(kwargs, interpret=True))

    monkeypatch.setattr(config, "trace_route",
                        lambda scene, dtype: route)
    monkeypatch.setattr(fused, "trace_fused", spy)
    arrays = bounce_arrays.replace(recursion=3)
    o, d = bounce_rays(n=128, seed=6)
    key = jax.random.PRNGKey(9)
    c_ref, m_ref = trace(arrays, o, d, key)
    c_rep, m_rep = trace_replay(arrays, o, d, key)
    assert calls == ([True] if route == "triton" else [])
    np.testing.assert_array_equal(np.asarray(m_rep), np.asarray(m_ref))
    close = np.all(np.abs(np.asarray(c_rep) - np.asarray(c_ref))
                   <= 1e-3 + 1e-3 * np.abs(np.asarray(c_ref)), axis=1)
    assert close.mean() > 0.97
