"""Multi-device tests on the 8-way virtual CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raytracercore.config import REPO_ROOT
from raytracercore.diff import get_material_params
from raytracercore.parallel import (make_mesh, make_sharded_render_pass,
                                    make_train_step, place_film,
                                    place_scene)
from raytracercore.parallel.mesh import ray_sharded
from raytracercore.render.film import Film
from raytracercore.render.renderer import render_pass
from raytracercore.scene import loader
from raytracercore.scene.types import freeze_scene, init_camera


@pytest.fixture(scope="module")
def small_setup(request):
    bounce = request.getfixturevalue("bounce_txt")
    scene = loader.parse(bounce)
    scene.width = scene.height = 16
    scene.recursion = 3
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], 16, 16)
    return scene, arrays, camera


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device(small_setup):
    scene, arrays, camera = small_setup
    mesh = make_mesh(n_rays=8)

    film0 = Film.create(16, 16)
    key = jax.random.PRNGKey(5)
    ref = render_pass(arrays, camera, film0, key)

    sharded = make_sharded_render_pass(mesh)
    film1 = place_film(mesh, Film.create(16, 16))
    got = sharded(place_scene(mesh, arrays), camera, film1, key)

    np.testing.assert_allclose(np.asarray(got.color_sum),
                               np.asarray(ref.color_sum), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.samples),
                                  np.asarray(ref.samples))
    # Output stays sharded by rows across the 8 devices.
    assert not got.color_sum.sharding.is_fully_replicated


def test_train_step_runs_sharded(small_setup):
    scene, arrays, camera = small_setup
    mesh = make_mesh(n_rays=8)
    arrays = place_scene(mesh, arrays)
    optimizer = optax.adam(1e-2)
    params = get_material_params(arrays)
    opt_state = optimizer.init(params)
    target = jax.device_put(jnp.zeros((16, 16, 3)), ray_sharded(mesh, 3))
    step = make_train_step(mesh, optimizer)
    p1, opt_state, loss = step(params, arrays, camera, target, opt_state,
                               jax.random.PRNGKey(0))
    assert jnp.isfinite(loss)
    # Material params must have moved (gradients flowed + were reduced).
    delta = sum(float(jnp.abs(p1[k] - params[k]).sum()) for k in params)
    assert delta > 0


def test_train_step_sharded_matches_single(small_setup):
    scene, arrays, camera = small_setup
    optimizer = optax.sgd(1e-2)
    params = get_material_params(arrays)
    target = jnp.zeros((16, 16, 3))
    key = jax.random.PRNGKey(3)

    s_single = make_train_step(None, optimizer)
    p_ref, _, loss_ref = s_single(params, arrays, camera, target,
                                  optimizer.init(params), key)

    mesh = make_mesh(n_rays=8)
    arr_sh = place_scene(mesh, arrays)
    tgt_sh = jax.device_put(target, ray_sharded(mesh, 3))
    s_sh = make_train_step(mesh, optimizer)
    p_sh, _, loss_sh = s_sh(params, arr_sh, camera, tgt_sh,
                            optimizer.init(params), key)

    assert float(loss_sh) == pytest.approx(float(loss_ref), rel=1e-5)
    for k in p_ref:
        np.testing.assert_allclose(np.asarray(p_sh[k]), np.asarray(p_ref[k]),
                                   atol=1e-6)


def test_prims_sharded_matches_single_device(small_setup):
    """The prims mesh axis: triangle table sharded 4 ways × rays 2 ways,
    per-bounce closest hit min-reduced across devices — must reproduce the
    single-device render exactly (same key ⇒ same paths)."""
    from raytracercore.parallel.shard import (
        make_prims_sharded_render_pass, pad_triangles_for_prims)

    scene, arrays, camera = small_setup
    mesh = make_mesh(n_rays=2, n_prims=4)

    key = jax.random.PRNGKey(11)
    ref = render_pass(arrays, camera, Film.create(16, 16), key)

    padded = pad_triangles_for_prims(arrays, 4)
    assert padded.triangles.v0.shape[0] % 4 == 0
    rp = make_prims_sharded_render_pass(mesh)
    got = rp(padded, camera, Film.create(16, 16), key)

    np.testing.assert_allclose(np.asarray(got.color_sum),
                               np.asarray(ref.color_sum), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.misses),
                                  np.asarray(ref.misses))


@pytest.mark.slow
def test_overlapped_train_step_matches_single(small_setup):
    """Per-bounce bucketed grad psum inside the backward unroll
    (make_overlapped_train_step) must equal the single-device step (psum
    is linear), and its HLO must actually schedule multiple all-reduces —
    the overlapped design artifact SURVEY §7.6 calls for."""
    from raytracercore.parallel.shard import make_overlapped_train_step

    scene, arrays, camera = small_setup
    optimizer = optax.sgd(1e-2)
    params = get_material_params(arrays)
    target = jnp.zeros((16, 16, 3))
    key = jax.random.PRNGKey(3)

    s_single = make_train_step(None, optimizer)
    p_ref, _, loss_ref = s_single(params, arrays, camera, target,
                                  optimizer.init(params), key)

    mesh = make_mesh(n_rays=8)
    s_ov = make_overlapped_train_step(mesh, optimizer)
    p_ov, _, loss_ov = s_ov(params, arrays, camera, target,
                            optimizer.init(params), key)
    assert float(loss_ov) == pytest.approx(float(loss_ref), rel=1e-5)
    for k in p_ref:
        np.testing.assert_allclose(np.asarray(p_ov[k]),
                                   np.asarray(p_ref[k]),
                                   atol=1e-6, err_msg=k)

    # Collective schedule: the material-gradient all-reduce must sit
    # INSIDE a loop region (the backward bounce unroll — one bucket psum
    # per bounce at runtime), not as a single fused reduction in ENTRY.
    # The material-bucket shape is derived from the scene (VERDICT r3: a
    # hard-coded "f32[14,22]" breaks silently if the material-matrix
    # column count or the test scene changes).
    from raytracercore.render.integrator import _material_matrix
    matm = _material_matrix(arrays.materials)
    bucket_shape = f"f32[{matm.shape[1]},{matm.shape[0]}]"
    hlo = jax.jit(s_ov).lower(params, arrays, camera, target,
                              optimizer.init(params), key
                              ).compile().as_text()
    cur, in_loop, in_entry = "", False, False
    for ln in hlo.splitlines():
        if ln.startswith("%") or ln.startswith("ENTRY"):
            cur = ln
        if "all-reduce(" in ln:
            if bucket_shape in ln and not cur.startswith("ENTRY"):
                in_loop = True     # per-bounce material bucket
            if ln.strip().startswith("%psum") and cur.startswith("ENTRY") \
                    and "f32[]" in ln:
                in_entry = True    # the scalar loss psum
    assert in_loop, ("material-grad psum (" + bucket_shape
                     + ") not scheduled inside the unroll")
    assert in_entry, "loss psum missing"


@pytest.mark.slow
def test_graft_entry_dryrun():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO_ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out.color_sum)
    assert bool(jnp.isfinite(out.color_sum).all())
    mod.dryrun_multichip(8)


def test_bvh_train_step_sharded_matches_single():
    """The AT-SCALE code path under the mesh (VERDICT r3 #7): a sharded
    train step whose closest hit routes through make_bvh_closest_fn must
    equal the single-device BVH step exactly (rays are embarrassingly
    parallel; the material-grad psum is the only collective)."""
    from raytracercore.bvh.builder import build_triangle_bvh
    from raytracercore.intersect.dispatch import make_bvh_closest_fn
    from raytracercore.parallel.shard import make_train_step
    from raytracercore.scene.meshgen import make_mesh_scene

    size = 16
    arrays, cam, (v0, e1, e2, mirror, valid) = make_mesh_scene(
        grid=2, subdiv=1, recursion=2, width=size, height=size)
    bvh = build_triangle_bvh(v0, e1, e2, mirror, valid, leaf_size=4,
                             backend="numpy")
    bvh_fn = make_bvh_closest_fn(bvh)
    camera = init_camera(cam, size, size)

    optimizer = optax.sgd(1e-2)
    params = get_material_params(arrays)
    target = jnp.zeros((size, size, 3))
    key = jax.random.PRNGKey(9)

    s1 = make_train_step(None, optimizer, closest_fn=bvh_fn)
    p1, _, l1 = s1(params, arrays, camera, target, optimizer.init(params),
                   key)

    mesh = make_mesh(n_rays=8)
    s8 = make_train_step(mesh, optimizer, closest_fn=bvh_fn)
    p8, _, l8 = s8(params, arrays, camera, target, optimizer.init(params),
                   key)
    assert float(l8) == pytest.approx(float(l1), rel=1e-6)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p8[k]), np.asarray(p1[k]),
                                   atol=1e-6, err_msg=k)


def test_train_loop_matches_sequential_steps(small_setup):
    """make_train_loop (one scanned program, round 5) must sample and step
    exactly like n sequential make_train_step calls with the same
    per-step key schedule (fold_in(key, i))."""
    from raytracercore.parallel.shard import make_train_loop

    scene, arrays, camera = small_setup
    optimizer = optax.sgd(1e-2)
    params = get_material_params(arrays)
    target = jnp.zeros((16, 16, 3))
    key = jax.random.PRNGKey(11)

    step = make_train_step(None, optimizer)
    p, o = params, optimizer.init(params)
    losses = []
    for i in range(3):
        p, o, loss = step(p, arrays, camera, target, o,
                          jax.random.fold_in(key, i))
        losses.append(float(loss))

    loop = make_train_loop(None, optimizer, n_steps=3)
    pl_, _, ll = loop(params, arrays, camera, target,
                      optimizer.init(params), key)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(losses),
                               rtol=1e-6)
    for k in p:
        np.testing.assert_allclose(np.asarray(pl_[k]), np.asarray(p[k]),
                                   atol=1e-7, err_msg=k)


def test_sharded_step_with_kernel_recorder_matches_single(small_setup,
                                                          monkeypatch):
    """With the megakernel as the recorder (route forced to "triton", the
    kernel in the interpreter), the GSPMD step runs the kernel per device
    under shard_map and matches the single-device step."""
    from raytracercore import config
    from raytracercore.render import fused

    real = fused.trace_fused
    monkeypatch.setattr(config, "trace_route",
                        lambda scene, dtype: "triton")
    monkeypatch.setattr(fused, "trace_fused", lambda *a, **k: real(
        *a, **dict(k, interpret=True)))
    scene, arrays, camera = small_setup
    optimizer = optax.sgd(1e-2)
    params = get_material_params(arrays)
    target = jnp.full((16, 16, 3), 0.5)
    key = jax.random.PRNGKey(13)
    p1, _, l1 = make_train_step(None, optimizer)(
        params, arrays, camera, target, optimizer.init(params), key)
    mesh = make_mesh(n_rays=4, devices=jax.devices()[:4])
    p4, _, l4 = make_train_step(mesh, optimizer)(
        params, place_scene(mesh, arrays), camera,
        jax.device_put(target, ray_sharded(mesh, 3)),
        optimizer.init(params), key)
    assert float(l4) == pytest.approx(float(l1), rel=1e-5)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p4[k]), np.asarray(p1[k]),
                                   atol=1e-6, err_msg=k)
