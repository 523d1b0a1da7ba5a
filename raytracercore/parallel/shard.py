"""Sharded render and optimization steps.

Replaces the reference's thread-pool orchestration (FullRaytracer.cs) with
SPMD over a device mesh: scene/BVH arrays replicated, pixels/rays sharded on
the ``rays`` axis, XLA inserting the collectives (loss/grad reductions run
over the cards' interconnect).  The film stays sharded by image rows; only display/IO gathers it.

The reference has no gradient path at all; the train step here optimizes the
material table against a target image — the "training" workload the
perf baseline measures (fwd+bwd rays/sec).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from ..diff import with_material_params
from ..intersect.dispatch import closest_hit
from ..render import camera as cam_mod
from ..render.film import Film
from ..render.integrator import prepare_uniforms, trace
from ..render.replay import trace_replay
from ..scene.types import SceneArrays, Triangles
from .mesh import ray_sharded, replicated


def place_scene(mesh: Mesh, scene: SceneArrays) -> SceneArrays:
    """Replicate the scene pytree on every device (SURVEY §2.5 strategy 2)."""
    return jax.device_put(scene, replicated(mesh))


def place_film(mesh: Mesh, film: Film) -> Film:
    """Shard the film by image rows over the rays axis."""
    rs = ray_sharded(mesh, 3)
    rs2 = ray_sharded(mesh, 2)
    return Film(color_sum=jax.device_put(film.color_sum, rs),
                samples=jax.device_put(film.samples, rs2),
                misses=jax.device_put(film.misses, rs2))


def make_sharded_render_pass(mesh: Mesh, closest_fn=closest_hit) -> Callable:
    """A jitted progressive pass with rays sharded over the mesh.

    Pixel index arrays are constrained to the rays axis; GSPMD propagates the
    sharding through camera-ray generation, the bounce loop and the film
    update, so each device traces its contiguous block of image rows.
    """
    rs1 = ray_sharded(mesh, 1)

    @jax.jit
    def render_pass(scene: SceneArrays, camera, film: Film, key) -> Film:
        h, w = film.shape
        px, py = cam_mod.pixel_grid(w, h)
        px = jax.lax.with_sharding_constraint(px, rs1)
        py = jax.lax.with_sharding_constraint(py, rs1)
        k_cam, k_path = jax.random.split(key)
        ray_o, ray_d = cam_mod.camera_rays(camera, px, py, k_cam)
        color, miss = trace(scene, ray_o, ray_d, k_path,
                            closest_fn=closest_fn)
        return film.add_full_frame(color, miss)

    return render_pass


def pad_triangles_for_prims(scene: SceneArrays, n_prims: int) -> SceneArrays:
    """Pad the triangle table so its row count divides the ``prims`` mesh
    axis; padding rows carry ``prim_id = -1`` and are masked by every
    selection path (jnp_ref.triangle_candidates ``table_ok``)."""
    tri = scene.triangles
    t = tri.v0.shape[0]
    pad = (-t) % n_prims
    if pad == 0:
        return scene
    pz = lambda a: jnp.concatenate(
        [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
    tri = Triangles(
        v0=pz(tri.v0), e1=pz(tri.e1), e2=pz(tri.e2), normal=pz(tri.normal),
        n0=pz(tri.n0), n1=pz(tri.n1), n2=pz(tri.n2),
        mirror=pz(tri.mirror), smooth=pz(tri.smooth),
        prim_id=jnp.concatenate(
            [tri.prim_id, jnp.full((pad,), -1, jnp.int32)]))
    return scene.replace(triangles=tri)


def make_prims_sharded_render_pass(mesh: Mesh) -> Callable:
    """A render pass with the TRIANGLE TABLE sharded over the ``prims``
    mesh axis — the tensor-parallel analog for a path tracer
    (parallel/mesh.py): each device intersects rays against its slice of
    the triangle table (spheres/planes are tiny and stay replicated), and
    the per-bounce closest hit is combined with a cross-device min
    reduction over ``prims`` inside the bounce loop.

    Rays are simultaneously sharded over ``rays``, so an (r, p) mesh runs
    r-way data parallelism × p-way primitive parallelism.  Duplicate
    sphere/plane candidates across the prims axis tie exactly in the min
    reduction, so the combined record equals the single-device result.

    Returns ``render_pass(scene, camera, film, key) → film`` where
    ``scene`` must be pre-padded with :func:`pad_triangles_for_prims`.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .mesh import PRIMS_AXIS, RAYS_AXIS

    def scene_spec(scene: SceneArrays):
        tri_spec = jax.tree.map(lambda _: P(PRIMS_AXIS), scene.triangles)
        rep = jax.tree.map(lambda _: P(), scene)
        return rep.replace(triangles=tri_spec)

    def closest_prims(scene, ray_o, ray_d, skip):
        local = closest_hit(scene, ray_o, ray_d, skip)
        # Cross-device winner: min over the prims axis keyed on t.
        t_key = jnp.where(local.found, local.t, jnp.inf)
        gather = lambda a: jax.lax.all_gather(a, PRIMS_AXIS)
        all_t = gather(t_key)                       # [p, R]
        win = jnp.argmin(all_t, axis=0)             # [R]

        def pick(a):
            g = gather(a)                           # [p, R, ...]
            idx = win.reshape((1,) + win.shape + (1,) * (a.ndim - 1))
            return jnp.take_along_axis(
                g, jnp.broadcast_to(idx, (1,) + g.shape[1:]), axis=0)[0]

        found = jnp.isfinite(jnp.min(all_t, axis=0))
        return local.replace(
            prim=jnp.where(found, pick(local.prim), -1),
            t=pick(local.t), position=pick(local.position),
            normal=pick(local.normal), inside=pick(local.inside))

    @jax.jit
    def render_pass(scene: SceneArrays, camera, film: Film, key) -> Film:
        h, w = film.shape
        spec = scene_spec(scene)

        # Rays and randomness are generated GLOBALLY (GSPMD shards them over
        # ``rays``); only the bounce loop runs under shard_map, so results
        # are bitwise-independent of the mesh layout.
        px, py = cam_mod.pixel_grid(w, h)
        k_cam, k_path = jax.random.split(key)
        ray_o, ray_d = cam_mod.camera_rays(camera, px, py, k_cam)
        uniforms = prepare_uniforms(k_path, h * w, scene.recursion + 1,
                                    ray_o.dtype)

        traced = shard_map(
            lambda s, o, d, u: trace(s, o, d, None,
                                     closest_fn=closest_prims, uniforms=u),
            mesh=mesh,
            in_specs=(spec, P(RAYS_AXIS, None), P(RAYS_AXIS, None),
                      P(None, None, RAYS_AXIS)),
            out_specs=(P(RAYS_AXIS, None), P(RAYS_AXIS)),
            # The all_gather+argmin combine makes per-bounce state
            # replicated over ``prims``, which the varying-axis checker
            # cannot see through.
            check_vma=False)
        color, miss = traced(scene, ray_o, ray_d, uniforms)
        return film.add_full_frame(color, miss)

    return render_pass


def make_overlapped_train_step(mesh: Mesh,
                               optimizer: optax.GradientTransformation
                               ) -> Callable:
    """Train step with the material-gradient all-reduce OVERLAPPED with
    the backward bounce unroll (SURVEY §5.8/§7.6).

    The GSPMD step (:func:`make_train_step`) leaves the reduction to XLA,
    which schedules one fused all-reduce after the whole backward.  Here
    the step runs under shard_map (rays sharded, params/scene replicated)
    and the replay inserts a psum per BOUNCE inside the backward unroll
    (render.replay._allreduce_in_bwd): bounce k's material-gradient bucket
    is in flight while bounce k-1's backward math still executes.  psum
    linearity makes the result equal to the fused schedule up to f32
    summation order (tested against the single-device step).

    Returns ``step(params, scene, camera, target, opt_state, key)
    → (params, opt_state, loss)``.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .mesh import RAYS_AXIS

    @jax.jit
    def step(params, scene: SceneArrays, camera, target, opt_state, key):
        h, w = target.shape[:2]
        px, py = cam_mod.pixel_grid(w, h)
        k_cam, k_path = jax.random.split(key)
        ray_o, ray_d = cam_mod.camera_rays(camera, px, py, k_cam)
        uniforms = prepare_uniforms(k_path, h * w, scene.recursion + 1,
                                    ray_o.dtype)
        tgt = target.reshape(h * w, 3)

        rep = jax.tree.map(lambda _: P(), (params, scene, camera))

        def shard_fn(params, scene, camera, o, d, u, tgt):
            def loss_fn(p):
                from ..render.replay import record_tape, replay
                s = with_material_params(scene, p)
                tape = record_tape(s, o, d, u)
                color, miss = replay(s, o, d, u, tape,
                                     grad_axis=RAYS_AXIS)
                img = jnp.where(miss[:, None], 0.0, color)
                # Local SUM; the global mean divides by the full count.
                return jnp.sum((img - tgt) ** 2) / (h * w * 3)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            # Per-bounce buckets already all-reduced the grads; only the
            # scalar loss still needs its own psum.
            return jax.lax.psum(loss, RAYS_AXIS), grads

        loss, grads = shard_map(
            shard_fn, mesh=mesh,
            in_specs=(rep[0], rep[1], rep[2], P(RAYS_AXIS, None),
                      P(RAYS_AXIS, None), P(None, None, RAYS_AXIS),
                      P(RAYS_AXIS, None)),
            out_specs=(P(), jax.tree.map(lambda _: P(), params)),
            check_vma=False)(params, scene, camera, ray_o, ray_d,
                             uniforms, tgt)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_train_step(mesh: Optional[Mesh], optimizer: optax.GradientTransformation,
                    closest_fn=closest_hit, use_replay: bool = True) -> Callable:
    """A jitted material-optimization step: render → L2 image loss → grads →
    optax update.

    With a mesh, pixels/target are sharded over ``rays`` and the parameter
    gradients are all-reduced by XLA (replicated params + sharded loss);
    pass ``mesh=None`` for single-device.

    ``use_replay`` routes the loss through the path-replay estimator
    (:func:`..render.replay.trace_replay`): the same values and gradients
    as ``trace`` (bitwise with the XLA recorder), but the backward pass
    differentiates only the [R]-shaped replay instead of re-running
    selection per bounce.  Set False to reverse-differentiate the full
    bounce loop (the slow oracle the replay is tested against).

    Returns ``step(params, scene, camera, target, opt_state, key)
    → (params, opt_state, loss)``.
    """
    rs1 = ray_sharded(mesh, 1) if mesh is not None else None
    if use_replay:
        trace_fn = functools.partial(trace_replay, mesh=mesh)
    else:
        trace_fn = trace

    @jax.jit
    def step(params, scene: SceneArrays, camera, target, opt_state, key):
        h, w = target.shape[:2]

        def loss_fn(p):
            s = with_material_params(scene, p)
            px, py = cam_mod.pixel_grid(w, h)
            if rs1 is not None:
                px = jax.lax.with_sharding_constraint(px, rs1)
                py = jax.lax.with_sharding_constraint(py, rs1)
            k_cam, k_path = jax.random.split(key)
            ray_o, ray_d = cam_mod.camera_rays(camera, px, py, k_cam)
            color, miss = trace_fn(s, ray_o, ray_d, k_path,
                                   closest_fn=closest_fn)
            img = jnp.where(miss[:, None], 0.0, color).reshape(h, w, 3)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_train_loop(mesh: Optional[Mesh],
                    optimizer: optax.GradientTransformation,
                    n_steps: int, closest_fn=closest_hit,
                    use_replay: bool = True) -> Callable:
    """``n_steps`` optimization steps in ONE jitted program (a
    ``lax.scan`` over :func:`make_train_step`'s body) — the idiomatic JAX
    training loop.  Each step draws a fresh key (``fold_in(key, i)``), so
    the sampling matches ``n_steps`` calls of the single-step version.

    One device program per ``n_steps`` steps pays host dispatch once.

    Returns ``loop(params, scene, camera, target, opt_state, key) →
    (params, opt_state, losses [n_steps])``.
    """
    step = make_train_step(mesh, optimizer, closest_fn=closest_fn,
                           use_replay=use_replay)

    @jax.jit
    def loop(params, scene: SceneArrays, camera, target, opt_state, key):
        def body(carry, i):
            p, o = carry
            p, o, loss = step(p, scene, camera, target, o,
                              jax.random.fold_in(key, i))
            return (p, o), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), jnp.arange(n_steps))
        return params, opt_state, losses

    return loop
