"""Benchmark: bounce.txt Cornell box at the reference's headline config.

Reference baseline (BASELINE.md): 6.240 samples/px/sec on bounce.txt at
700x700, recursion 10, on the author's multi-core AVX2 x86 (status bar in
Screenshots/app.png; metric computed by FullRaytracer.cs:346-357).  The
scene here is the in-repo reconstruction (scenes/bounce.txt).

Sections, each timed with ``block_until_ready`` after a compile call:

* forward progressive passes by the route ``config.trace_route`` picks
  (the Triton megakernel on a GPU), in samples/px/sec;
* the fwd+bwd material-fit step, one dispatch per step and as a scanned
  ``make_train_loop``, in steps/sec;
* two passes of the 184k-triangle mesh scene at 512x512, recursion 4,
  through the BVH.

A section that fails stops the run with a non-zero exit.  Prints the card's
name and power limit, then ONE JSON line.  Needs a GPU.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

BASELINE_SAMPLES_PX_SEC = 6.240
SIZE = 700
RECURSION = 10
PASSES = 6
TIMED = 5


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_call(fn, n=TIMED):
    """Seconds per call of ``fn`` over ``n`` calls, after one call that
    compiles."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    import optax

    from chip_smoke import card_line, load_bounce
    from raytracercore.bvh.builder import build_triangle_bvh
    from raytracercore.config import enable_compile_cache, trace_route
    from raytracercore.diff import get_material_params
    from raytracercore.intersect.dispatch import make_bvh_closest_fn
    from raytracercore.parallel.shard import make_train_loop, make_train_step
    from raytracercore.render import fused
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_passes
    from raytracercore.scene.meshgen import make_mesh_scene
    from raytracercore.scene.types import freeze_scene, init_camera

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: no GPU (JAX found {dev.platform})")
        return 2
    enable_compile_cache()
    card = card_line()
    log(f"bench: card {card}")

    scene = load_bounce(SIZE, RECURSION)
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], SIZE, SIZE)
    film = Film.create(SIZE, SIZE)
    key = jax.random.PRNGKey(0)
    pixels = SIZE * SIZE

    # --- forward ---------------------------------------------------------
    route = trace_route(arrays, jnp.float32)
    trace_fn = fused.trace_fused if route == "triton" else None
    dt_fwd = bench_call(lambda: render_passes(
        arrays, camera, film, key, jnp.int32(0), n=PASSES,
        trace_fn=trace_fn)) / PASSES
    log(f"bench: forward ({route}) {1.0 / dt_fwd:.3f} samples/px/sec")

    # --- forward+backward (path-replay material-gradient train step) ------
    optimizer = optax.adam(1e-2)
    params = get_material_params(arrays)
    target = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
    step = make_train_step(None, optimizer)
    opt_state = optimizer.init(params)
    dt_step = bench_call(lambda: step(params, arrays, camera, target,
                                      opt_state, key))
    loop_k = 10
    loop = make_train_loop(None, optimizer, n_steps=loop_k)
    dt_loop = bench_call(lambda: loop(params, arrays, camera, target,
                                      opt_state, key)) / loop_k
    log(f"bench: fwd+bwd {1.0 / dt_step:.3f} steps/sec per call, "
        f"{1.0 / dt_loop:.3f} scanned")

    # --- 184k-triangle BVH pass ----------------------------------------------
    size_b, rec_b = 512, 4
    arrays_b, cam_b, (v0, e1, e2, mirror, valid) = make_mesh_scene(
        grid=12, subdiv=3, recursion=rec_b, width=size_b, height=size_b)
    bvh = build_triangle_bvh(v0, e1, e2, mirror, valid)
    closest_b = make_bvh_closest_fn(bvh)
    camera_b = init_camera(cam_b, size_b, size_b)
    film_b = Film.create(size_b, size_b)
    dt_bvh = bench_call(lambda: render_passes(
        arrays_b, camera_b, film_b, key, jnp.int32(0), n=2,
        closest_fn=closest_b), n=3) / 2
    log(f"bench: 184k BVH {dt_bvh * 1e3:.1f} ms/pass")

    spp_sec = 1.0 / dt_fwd
    print(json.dumps({
        "metric": "samples/px/sec fwd, bounce.txt 700x700 rec10",
        "value": spp_sec,
        "unit": "samples/px/sec",
        "vs_baseline": spp_sec / BASELINE_SAMPLES_PX_SEC,
        "extra": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            "forward_route": route,
            "wavefront_rays_per_sec_fwd": pixels * (RECURSION + 1) / dt_fwd,
            "fwdbwd_steps_per_sec": 1.0 / dt_loop,
            "fwdbwd_steps_per_sec_percall": 1.0 / dt_step,
            "bvh_184k_ms_per_pass": dt_bvh * 1e3,
            "bvh_184k_n_tris": int(v0.shape[0]),
            "bvh_184k_leaf_size": int(bvh.leaf_prims.shape[1]),
            "baseline_samples_px_sec": BASELINE_SAMPLES_PX_SEC,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
