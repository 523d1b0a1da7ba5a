"""Card timings behind the route choices in ``config`` (see PERF.md).

    python scripts/route_timings.py [--out chiprun_out/route_timings.json]

Each comparison compiles every variant first, then runs them in turns
(A B B A) on the same card, several calls each, every call ended by
``block_until_ready``; the median per call is reported.  Sections:

* render   — megakernel vs XLA ``trace`` (early_exit=False) for the
             forward pass, bounce.txt 700x700 rec10;
* record   — the train step with the megakernel vs the XLA recorder;
* gather   — one-hot matmul vs ``jnp.take`` for the material gather, in
             the XLA forward pass and in the train step;
* step     — the train step's parts: uniforms, record, replay fwd+bwd;
* block    — megakernel rays per program and warps;
* closest  — XLA ``closest_hit`` on 490k rays at 22 and 512 rows;
* dense_vs_bvh — megakernel vs BVH render at 512 and 2048 triangles;
* leaf     — BVH leaf width (8 / 32 / 128) on the 184k-triangle scene.

Needs a GPU.  Prints one line per measurement and writes them all as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RESULTS = {}
SIZE = 700        # bounce.txt frame, the reference's headline size
MESH_SIZE = 512   # mesh-scene frame


def compile_fn(fn, *args, **kwargs):
    t0 = time.perf_counter()
    c = jax.jit(fn, **kwargs).lower(*args).compile()
    return c, time.perf_counter() - t0


def run_turns(section, variants, reps=5, per_call=1):
    """``variants``: {name: (compiled, args, compile_s)}.  Runs A B B A
    (for two variants; round-robin there and back for more), ``reps``
    timed calls per turn after one warm call; seconds per unit of work
    (call / ``per_call``)."""
    names = list(variants)
    times = {n: [] for n in names}
    for n in names:
        c, args, _ = variants[n]
        jax.block_until_ready(c(*args))
    for n in names + names[::-1]:
        c, args, _ = variants[n]
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(c(*args))
            times[n].append((time.perf_counter() - t0) / per_call)
    out = {}
    for n in names:
        med = statistics.median(times[n])
        out[n] = {"median_s": med, "min_s": min(times[n]),
                  "max_s": max(times[n]), "compile_s": variants[n][2]}
        print(f"{section}: {n}: median {med * 1e3:.3f} ms "
              f"(min {min(times[n]) * 1e3:.3f}, max "
              f"{max(times[n]) * 1e3:.3f}) compile {variants[n][2]:.1f}s",
              flush=True)
    RESULTS[section] = out
    return out


def bounce_setup(recursion=10):
    from chip_smoke import load_bounce
    from raytracercore.scene.types import freeze_scene, init_camera

    scene = load_bounce(SIZE, recursion)
    return freeze_scene(scene), init_camera(scene.cameras[0], SIZE, SIZE)


def section_render():
    from raytracercore.render import fused
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_passes

    arrays, camera = bounce_setup()
    film = Film.create(SIZE, SIZE)
    key = jax.random.PRNGKey(0)
    n = 3
    variants = {}
    for name, tf in (("triton", fused.trace_fused), ("xla", None)):
        c, t = compile_fn(lambda a, c_, f, k, tf=tf: render_passes(
            a, c_, f, k, jnp.int32(0), n=n, trace_fn=tf),
            arrays, camera, film, key)
        variants[name] = (c, (arrays, camera, film, key), t)
    run_turns("render (s/pass)", variants, per_call=n)


def _train_variants(routes=("triton", "xla"), onehot=(1024,)):
    import optax

    from raytracercore import config
    from raytracercore.diff import get_material_params
    from raytracercore.parallel.shard import make_train_step
    from raytracercore.render import integrator, replay

    arrays, camera = bounce_setup()
    opt = optax.adam(1e-2)
    params = get_material_params(arrays)
    state = opt.init(params)
    target = jnp.full((SIZE, SIZE, 3), 0.5, jnp.float32)
    key = jax.random.PRNGKey(1)
    args = (params, arrays, camera, target, state, key)
    real_route = config.trace_route
    variants = {}
    try:
        for route in routes:
            for rows in onehot:
                config.trace_route = lambda s, dt, r=route: r
                integrator.ONEHOT_MAX_ROWS = rows
                replay.ONEHOT_MAX_ROWS = rows
                step = make_train_step(None, opt)
                t0 = time.perf_counter()
                c = step.lower(*args).compile()
                name = f"{route} recorder" + (
                    f", one-hot max rows {rows}" if len(onehot) > 1 else "")
                variants[name] = (c, args, time.perf_counter() - t0)
    finally:
        config.trace_route = real_route
        integrator.ONEHOT_MAX_ROWS = replay.ONEHOT_MAX_ROWS = 1024
    return variants


def section_record():
    run_turns("train step by recorder (s/step)", _train_variants())


def section_gather():
    from raytracercore.render import integrator
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_passes

    arrays, camera = bounce_setup()
    film = Film.create(SIZE, SIZE)
    key = jax.random.PRNGKey(0)
    variants = {}
    try:
        for rows in (1024, 0):
            integrator.ONEHOT_MAX_ROWS = rows
            c, t = compile_fn(lambda a, c_, f, k: render_passes(
                a, c_, f, k, jnp.int32(0), n=1), arrays, camera, film, key)
            variants["one-hot" if rows else "take"] = (
                c, (arrays, camera, film, key), t)
    finally:
        integrator.ONEHOT_MAX_ROWS = 1024
    run_turns("gather in XLA forward pass (s/pass)", variants)
    tv = _train_variants(routes=("triton",), onehot=(1024, 0))
    run_turns("gather in train step (s/step)", tv)


def section_step_parts():
    from raytracercore.diff import get_material_params, with_material_params
    from raytracercore.render import camera as cam_mod
    from raytracercore.render.integrator import prepare_uniforms
    from raytracercore.render.replay import record_tape, replay

    arrays, camera = bounce_setup()
    px, py = cam_mod.pixel_grid(SIZE, SIZE)
    key = jax.random.PRNGKey(1)
    ray_o, ray_d = jax.jit(lambda: cam_mod.camera_rays(
        camera, px, py, key))()
    n_b = arrays.recursion + 1
    target = jnp.full((SIZE * SIZE, 3), 0.5, jnp.float32)
    params = get_material_params(arrays)

    uni_c, t_u = compile_fn(
        lambda k: prepare_uniforms(k, SIZE * SIZE, n_b), key)
    u = uni_c(key)
    rec_c, t_r = compile_fn(lambda a, o, d, u: record_tape(a, o, d, u),
                            arrays, ray_o, ray_d, u)
    tape = rec_c(arrays, ray_o, ray_d, u)

    def loss(p, o, d, u, tape):
        color, miss = replay(with_material_params(arrays, p), o, d, u, tape)
        img = jnp.where(miss[:, None], 0.0, color)
        return jnp.mean((img - target) ** 2)

    rep_c, t_p = compile_fn(jax.value_and_grad(loss), params, ray_o, ray_d,
                            u, tape)
    run_turns("train step parts (s)", {
        "uniforms": (uni_c, (key,), t_u),
        "record (megakernel on a GPU)": (rec_c, (arrays, ray_o, ray_d, u),
                                         t_r),
        "replay fwd+bwd": (rep_c, (params, ray_o, ray_d, u, tape), t_p)})


def section_block():
    from raytracercore.render import camera as cam_mod
    from raytracercore.render import fused
    from raytracercore.render.integrator import prepare_uniforms

    arrays, camera = bounce_setup()
    px, py = cam_mod.pixel_grid(SIZE, SIZE)
    o, d = jax.jit(lambda: cam_mod.camera_rays(camera, px, py,
                                               jax.random.PRNGKey(2)))()
    u = jax.jit(lambda: prepare_uniforms(jax.random.PRNGKey(3), SIZE * SIZE,
                                         arrays.recursion + 1))()
    variants = {}
    for block in (128, 256, 512):
        for warps in (4, 8):
            c, t = compile_fn(lambda o, d, u, b=block, w=warps:
                              fused.trace_fused(arrays, o, d, None,
                                                uniforms=u, block=b,
                                                num_warps=w),
                              o, d, u)
            variants[f"block {block} warps {warps}"] = (c, (o, d, u), t)
    run_turns("megakernel block (s/pass, trace only)", variants, reps=3)


def mesh_subset(n_tris, recursion=4):
    """The first ``n_tris - 2`` sphere triangles of the mesh scene plus its
    floor and light, with their own BVH inputs."""
    from raytracercore.scene.meshgen import make_mesh_scene

    arrays, cam, (v0, e1, e2, mirror, valid) = make_mesh_scene(
        grid=12, subdiv=3, recursion=recursion, width=MESH_SIZE,
        height=MESH_SIZE)
    t = v0.shape[0]
    idx = np.concatenate([np.arange(n_tris - 2), [t - 2, t - 1]])
    take = lambda a: a[idx]
    tri = jax.tree.map(take, arrays.triangles)
    tri = tri.replace(prim_id=jnp.arange(n_tris, dtype=jnp.int32))
    sub = arrays.replace(triangles=tri,
                         materials=jax.tree.map(take, arrays.materials),
                         n_prims=n_tris)
    return sub, cam, tuple(a[idx] for a in (v0, e1, e2, mirror, valid))


def section_closest():
    from raytracercore.intersect.dispatch import closest_hit
    from raytracercore.render import camera as cam_mod
    from raytracercore.scene.types import init_camera

    px, py = cam_mod.pixel_grid(SIZE, SIZE)
    variants = {}
    arrays, camera = bounce_setup()
    sub, host_cam, _ = mesh_subset(512)
    for name, (a, cam) in (
            ("22 rows (bounce.txt)", (arrays, camera)),
            ("512 rows (mesh subset)",
             (sub, init_camera(host_cam, SIZE, SIZE)))):
        o, d = jax.jit(lambda cam=cam: cam_mod.camera_rays(
            cam, px, py, jax.random.PRNGKey(4)))()
        c, t = compile_fn(lambda a, o, d: closest_hit(a, o, d, None),
                          a, o, d)
        variants[name] = (c, (a, o, d), t)
    run_turns("XLA closest_hit, 490k primary rays (s)", variants)


def section_dense_vs_bvh(counts=(512, 2048)):
    from raytracercore.bvh.builder import build_triangle_bvh
    from raytracercore.intersect.dispatch import make_bvh_closest_fn
    from raytracercore.render import fused
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_passes
    from raytracercore.scene.types import init_camera

    key = jax.random.PRNGKey(5)
    film = Film.create(MESH_SIZE, MESH_SIZE)
    for n in counts:
        a, host_cam, tris = mesh_subset(n)
        cam = init_camera(host_cam, MESH_SIZE, MESH_SIZE)
        closest = make_bvh_closest_fn(build_triangle_bvh(*tris))
        variants = {}
        for name, kw in (("megakernel", {"trace_fn": fused.trace_fused}),
                         ("bvh", {"closest_fn": closest})):
            c, t = compile_fn(lambda a, c_, f, k, kw=kw: render_passes(
                a, c_, f, k, jnp.int32(0), n=1, **kw), a, cam, film, key)
            variants[name] = (c, (a, cam, film, key), t)
        run_turns(f"dense vs bvh at {n} tris, 512x512 rec4 (s/pass)",
                  variants, reps=3)


def section_leaf(leaves=(8, 32, 128)):
    from raytracercore.bvh.builder import build_triangle_bvh
    from raytracercore.intersect.dispatch import make_bvh_closest_fn
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_passes
    from raytracercore.scene.meshgen import make_mesh_scene
    from raytracercore.scene.types import init_camera

    arrays, host_cam, tris = make_mesh_scene(
        grid=12, subdiv=3, recursion=4, width=MESH_SIZE, height=MESH_SIZE)
    cam = init_camera(host_cam, MESH_SIZE, MESH_SIZE)
    film = Film.create(MESH_SIZE, MESH_SIZE)
    key = jax.random.PRNGKey(6)
    variants = {}
    for leaf in leaves:
        t0 = time.perf_counter()
        bvh = build_triangle_bvh(*tris, leaf_size=leaf)
        t_build = time.perf_counter() - t0
        closest = make_bvh_closest_fn(bvh)
        c, t = compile_fn(lambda a, c_, f, k, cl=closest: render_passes(
            a, c_, f, k, jnp.int32(0), n=1, closest_fn=cl),
            arrays, cam, film, key)
        print(f"leaf {leaf}: nodes {bvh.n_nodes} build {t_build:.2f}s",
              flush=True)
        variants[f"leaf {leaf}"] = (c, (arrays, cam, film, key), t)
    run_turns("BVH leaf width, 184k tris 512x512 rec4 (s/pass)", variants,
              reps=2)


SECTIONS = {"render": section_render, "record": section_record,
            "gather": section_gather, "step": section_step_parts,
            "block": section_block, "closest": section_closest,
            "dense_vs_bvh": section_dense_vs_bvh, "leaf": section_leaf}


def main():
    from chip_smoke import card_line
    from raytracercore.config import enable_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/route_timings.json")
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--counts", default="512,2048",
                    help="triangle counts for dense_vs_bvh")
    ap.add_argument("--leaves", default="8,32,128",
                    help="leaf widths for leaf")
    args = ap.parse_args()
    ints = lambda s: tuple(int(v) for v in s.split(","))
    kwargs = {"dense_vs_bvh": {"counts": ints(args.counts)},
              "leaf": {"leaves": ints(args.leaves)}}
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"route_timings: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_line()
    print(f"card: {card} | jax {jax.__version__}", flush=True)
    for name in args.sections.split(","):
        SECTIONS[name](**kwargs.get(name, {}))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": card, "device_kind": dev.device_kind,
         "results": RESULTS}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
