"""Smoke test of the main path on one GPU: the quickest proof that the system
still starts and computes the right thing on the card.

    python chip_smoke.py               # (a), (b) and (c) on one card
    python chip_smoke.py --four-cards  # the sharded path on four cards only

Phases, each through the entry points a user calls:

(a) forward progressive render: ``Renderer(scene).step(n)`` on
    ``scenes/bounce.txt`` at 700x700, recursion 10; the Triton megakernel
    is compared with the XLA integrator on one shared uniform set over the
    full frame.
(b) material-fit step: ``make_train_step(None, adam)`` and
    ``make_train_loop`` on the same scene and size; the replay step's
    material gradients are compared with full AD of ``trace``.
(c) BVH render: the 184,322-triangle mesh scene at 512x512, recursion 4,
    through ``make_bvh_closest_fn`` and ``render_passes``; the BVH walk is
    compared with the dense ``closest_hit`` on primary and first-bounce
    rays.

Each phase prints one line: shapes, compile and run seconds, its comparison
with the measured error beside the tolerance, and ``memory_analysis()`` of
its compiled step.  The first line names the card, its power limit, the JAX
version and the device kind; the last line is the JSON verdict.  A phase
that fails raises, and the script exits non-zero without the verdict.
Without a GPU it exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


class SmokeFailure(AssertionError):
    """A comparison or sanity check of a phase did not hold."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return " | ".join(line.strip() for line in out.splitlines() if line)


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory n/a"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory " + " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(m, f)}"
        for f in fields if hasattr(m, f))


def _compile(fn, *args, **kwargs):
    """AOT-compile ``fn`` (a jitted function) for these arguments; returns
    (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **kwargs).compile()
    return compiled, time.perf_counter() - t0


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def capture_grads():
    """An optax transformation that leaves the parameters where they are
    and keeps the gradient of the last step as its state, so a train step
    built on it returns its exact gradients."""
    import optax

    return optax.GradientTransformation(
        init=lambda params: jax.tree.map(jnp.zeros_like, params),
        update=lambda grads, state, params=None:
            (jax.tree.map(jnp.zeros_like, grads), grads))


def _rel_l2(a, b) -> float:
    fa = np.concatenate([np.ravel(x) for x in jax.tree.leaves(a)])
    fb = np.concatenate([np.ravel(x) for x in jax.tree.leaves(b)])
    return float(np.linalg.norm(fa - fb) / max(np.linalg.norm(fb), 1e-30))


def load_bounce(size: int, recursion: int):
    from raytracercore.config import SCENES_DIR
    from raytracercore.scene import loader

    scene = loader.from_file(str(SCENES_DIR / "bounce.txt"))
    scene.width = scene.height = size
    scene.recursion = recursion
    return scene


def compare_paths(ref, got):
    """Kernel-vs-XLA agreement of two (color, miss, tape) traces of the same
    rays on the same uniforms.

    Mismatched rays (|Δ| > 1e-3 + 1e-3·|ref| in any channel) are split by
    their recorded paths, compared bounce by bounce up to the reference
    path's first terminal code:

    * flip     — a discrete pick (code, prim, inside/Fresnel bits) differs:
                 a knife-edge branch or primitive flip, where the two
                 compilers round differently near a comparison threshold;
    * graze    — same picks but hit normals more than 1e-2 apart: a
                 grazing-angle geometric knife-edge;
    * samepick — same picks and normals yet a different color: an
                 arithmetic fault in one of the two.

    Returns a dict of fractions of all rays: close, miss (miss-map
    agreement), flip, graze, samepick.
    """
    from raytracercore.render.integrator import BounceType, PathTape

    ref_c, got_c = np.asarray(ref[0]), np.asarray(got[0])
    miss_eq = float((np.asarray(ref[1]) == np.asarray(got[1])).mean())
    close = np.all(np.abs(ref_c - got_c) <= 1e-3 + 1e-3 * np.abs(ref_c),
                   axis=1)
    ref_t, got_t = ref[2], got[2]
    flags_r, flags_g = np.asarray(ref_t.flags), np.asarray(got_t.flags)
    codes_r = flags_r & PathTape.CODE_MASK
    codes_g = flags_g & PathTape.CODE_MASK
    prim_r, prim_g = np.asarray(ref_t.prim), np.asarray(got_t.prim)
    nrm_r = np.stack([np.asarray(a) for a in (ref_t.nx, ref_t.ny,
                                              ref_t.nz)], axis=-1)
    nrm_g = np.stack([np.asarray(a) for a in (got_t.nx, got_t.ny,
                                              got_t.nz)], axis=-1)
    bounced = [BounceType.DIFFUSE, BounceType.SPECULAR,
               BounceType.TRANSMITTED]
    bits = PathTape.FLAG_INSIDE | PathTape.FLAG_FLIVE
    live = np.ones(ref_c.shape[0], bool)
    path_eq = np.ones(ref_c.shape[0], bool)
    nrm_eq = np.ones(ref_c.shape[0], bool)
    for i in range(codes_r.shape[0]):
        cr, cg = codes_r[i], codes_g[i]
        is_b = np.isin(cr, bounced)
        same = (cr == cg) & (~is_b | ((prim_r[i] == prim_g[i])
                                      & ((flags_r[i] & bits)
                                         == (flags_g[i] & bits))))
        n_close = np.abs(nrm_r[i] - nrm_g[i]).max(axis=-1) <= 1e-2
        path_eq &= ~live | same
        nrm_eq &= ~(live & is_b & same) | n_close
        live &= is_b & same
    mismatch = ~close
    return {"close": float(close.mean()), "miss": miss_eq,
            "flip": float((mismatch & ~path_eq).mean()),
            "graze": float((mismatch & path_eq & ~nrm_eq).mean()),
            "samepick": float((mismatch & path_eq & nrm_eq).mean())}


def phase_render(size=700, recursion=10, passes=3, interpret=False):
    """(a) progressive forward render, and megakernel vs XLA ``trace``."""
    from raytracercore.render import camera as cam_mod
    from raytracercore.render import fused
    from raytracercore.render.integrator import prepare_uniforms, trace
    from raytracercore.render.renderer import Renderer, render_passes

    scene = load_bounce(size, recursion)
    r = Renderer(scene)
    route = "triton" if r.trace_fn is not None else "xla"
    compiled, t_compile = _compile(
        render_passes, r.arrays, r.camera, r.film, r._base_key,
        jnp.int32(0), n=passes, closest_fn=r.closest_fn,
        trace_fn=r.trace_fn)
    r.step(passes)                      # compiles (or hits the cache)
    t0 = time.perf_counter()
    r.step(passes)
    t_run = (time.perf_counter() - t0) / passes
    film = r.film
    color = np.asarray(film.color_sum)
    check(color.shape == (size, size, 3) and np.isfinite(color).all(),
          f"film {color.shape} not finite")
    check(bool((np.asarray(film.samples) + np.asarray(film.misses)
                == 2 * passes).all()), "sample counts wrong")
    check(r.image().shape == (size, size, 4), "image shape")

    # Megakernel vs the XLA integrator: full frame, one uniform set.
    px, py = cam_mod.pixel_grid(size, size)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(7))
    ray_o, ray_d = cam_mod.camera_rays(r.camera, px, py, k_cam)
    uniforms = jax.jit(prepare_uniforms, static_argnums=(1, 2))(
        k_path, size * size, recursion + 1)
    ref = jax.jit(lambda u: trace(r.arrays, ray_o, ray_d, None, uniforms=u,
                                  want_tape=True))(uniforms)
    got = jax.jit(lambda u: fused.trace_fused(
        r.arrays, ray_o, ray_d, None, uniforms=u, want_tape=True,
        interpret=interpret))(uniforms)
    cmp = compare_paths(ref, got)
    print(f"(a) render: bounce.txt {size}x{size} rec{recursion} "
          f"rays={size * size} passes={passes} route={route} "
          f"compile={t_compile:.2f}s run={t_run:.4f}s/pass "
          f"({1.0 / t_run:.3f} samples/px/s) | megakernel vs trace: "
          f"close={cmp['close']:.6f} (>=0.999) miss={cmp['miss']:.6f} "
          f"(>=0.9999) flip={cmp['flip']:.6f} graze={cmp['graze']:.6f} "
          f"samepick={cmp['samepick']:.6f} (==0) | {_mem(compiled)}",
          flush=True)
    check(cmp["samepick"] == 0, f"samepick {cmp['samepick']}")
    check(cmp["close"] >= 0.999, f"close {cmp['close']}")
    check(cmp["miss"] >= 0.9999, f"miss map {cmp['miss']}")
    return cmp


def phase_train(size=700, recursion=10, steps=3, grad_size=None):
    """(b) material-fit step and loop; replay gradients vs full AD."""
    import optax

    from raytracercore.diff import get_material_params
    from raytracercore.parallel.shard import make_train_loop, make_train_step
    from raytracercore.scene.types import freeze_scene, init_camera

    def setup(n):
        scene = load_bounce(n, recursion)
        arrays = freeze_scene(scene)
        camera = init_camera(scene.cameras[0], n, n)
        target = jnp.full((n, n, 3), 0.5, jnp.float32)
        return arrays, camera, target

    arrays, camera, target = setup(size)
    opt = optax.adam(1e-2)
    params = get_material_params(arrays)
    state = opt.init(params)
    key = jax.random.PRNGKey(1)
    step = make_train_step(None, opt)
    compiled, t_compile = _compile(step, params, arrays, camera, target,
                                   state, key)
    p, s = params, state
    losses = []
    for i in range(steps):
        (p, s, loss), t_run = _timed(compiled, p, arrays, camera, target, s,
                                     jax.random.fold_in(key, i))
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"losses {losses}")
    moved = max(float(jnp.abs(a - b).max()) for a, b in
                zip(jax.tree.leaves(p), jax.tree.leaves(params)))
    check(moved > 0, "material params did not move")
    loop = make_train_loop(None, opt, n_steps=steps)
    (_, _, loop_losses), _ = _timed(loop, params, arrays, camera, target,
                                    opt.init(params), key)
    check(bool(jnp.isfinite(loop_losses).all()), "loop losses not finite")

    # Replay gradients vs full AD of trace, same key.
    gs = grad_size or size
    g_arrays, g_camera, g_target = setup(gs)
    cap = capture_grads()
    g_params = get_material_params(g_arrays)
    runs = {}
    for use_replay in (True, False):
        fn = make_train_step(None, cap, use_replay=use_replay)
        _, grads, loss = fn(g_params, g_arrays, g_camera, g_target,
                            cap.init(g_params), key)
        runs[use_replay] = (jax.device_get(grads), float(loss))
    rel = _rel_l2(runs[True][0], runs[False][0])
    loss_rel = abs(runs[True][1] - runs[False][1]) / abs(runs[False][1])
    print(f"(b) train: bounce.txt {size}x{size} rec{recursion} "
          f"rays={size * size} steps={steps} compile={t_compile:.2f}s "
          f"run={t_run:.4f}s/step losses={[round(x, 6) for x in losses]} "
          f"moved={moved:.3e} | replay vs full AD at {gs}x{gs}: "
          f"grad rel L2={rel:.3e} (<=1e-3) loss rel={loss_rel:.3e} "
          f"(<=1e-4) | {_mem(compiled)}", flush=True)
    check(rel <= 1e-3, f"gradient rel L2 {rel}")
    check(loss_rel <= 1e-4, f"loss rel {loss_rel}")
    return rel, loss_rel


def phase_bvh(grid=12, subdiv=3, size=512, recursion=4, passes=2,
              n_check=16384, chunk=256):
    """(c) BVH render pass, and BVH walk vs dense ``closest_hit``."""
    from raytracercore.bvh.builder import build_triangle_bvh
    from raytracercore.intersect.dispatch import (HitRecord, closest_hit,
                                                  make_bvh_closest_fn)
    from raytracercore.render import camera as cam_mod
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_passes
    from raytracercore.scene.meshgen import make_mesh_scene
    from raytracercore.scene.types import init_camera

    arrays, host_cam, (v0, e1, e2, mirror, valid) = make_mesh_scene(
        grid=grid, subdiv=subdiv, recursion=recursion, width=size,
        height=size)
    n_tris = int(v0.shape[0])
    t0 = time.perf_counter()
    bvh = build_triangle_bvh(v0, e1, e2, mirror, valid)
    t_build = time.perf_counter() - t0
    closest = make_bvh_closest_fn(bvh)
    camera = init_camera(host_cam, size, size)
    film = Film.create(size, size)
    key = jax.random.PRNGKey(3)
    compiled, t_compile = _compile(render_passes, arrays, camera, film, key,
                                   jnp.int32(0), n=passes, closest_fn=closest)
    out, t_run = _timed(compiled, arrays, camera, film, key, jnp.int32(0))
    color = np.asarray(out.color_sum)
    check(np.isfinite(color).all() and color.max() > 0, "BVH film")

    # Primary rays over the whole frame, then first-bounce rays leaving the
    # primary hits on a random hemisphere, with the primary hit as the skip
    # record.
    px, py = cam_mod.pixel_grid(size, size)
    sel = np.random.default_rng(0).choice(size * size, n_check, replace=False)
    o, d = cam_mod.camera_rays(camera, px[sel], py[sel],
                               jax.random.PRNGKey(4))

    def dense(o, d, skip):
        def one(args):
            return closest_hit(arrays, *args)
        parts = (o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3))
        if skip is not None:
            parts += (jax.tree.map(
                lambda a: a.reshape((-1, chunk) + a.shape[1:]), skip),)
        else:
            parts += (None,)
        hit = jax.lax.map(lambda a: one(a), parts)
        return jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), hit)

    dense_j = jax.jit(dense)
    bvh_j = jax.jit(lambda o, d, skip: closest(arrays, o, d, skip))
    primary = dense_j(o, d, None)
    rnd = jax.random.normal(jax.random.PRNGKey(5), (n_check, 3))
    rnd = rnd / jnp.linalg.norm(rnd, axis=1, keepdims=True)
    d1 = rnd * jnp.sign(jnp.sum(rnd * primary.normal, axis=1,
                                keepdims=True))
    found = primary.found[:, None]
    o1 = jnp.where(found, primary.position, o)
    d1 = jnp.where(found, d1, d)
    skip = HitRecord(prim=primary.prim, t=primary.t,
                     position=primary.position, normal=primary.normal,
                     inside=primary.inside)
    worst = {}
    for name, (oo, dd, sk) in {"primary": (o, d, None),
                               "bounce": (o1, d1, skip)}.items():
        ref = dense_j(oo, dd, sk)
        got = bvh_j(oo, dd, sk)
        diff = float((np.asarray(ref.prim) != np.asarray(got.prim)).mean())
        both = np.asarray(ref.found & got.found)
        t_r, t_g = np.asarray(ref.t)[both], np.asarray(got.t)[both]
        t_rel = float(np.max(np.abs(t_r - t_g) / np.maximum(np.abs(t_r),
                                                               1e-30),
                             initial=0.0))
        worst[name] = (diff, t_rel, float(both.mean()))
    print(f"(c) bvh: mesh {n_tris} tris leaf={bvh.leaf_prims.shape[1]} "
          f"nodes={bvh.n_nodes} {size}x{size} rec{recursion} "
          f"passes={passes} build={t_build:.2f}s compile={t_compile:.2f}s "
          f"run={t_run / passes:.4f}s/pass | BVH vs dense on {n_check} rays: "
          + " ".join(f"{k}: prim_diff={v[0]:.2e} (<=1e-4) "
                     f"t_rel={v[1]:.2e} (<=1e-5) hit={v[2]:.3f}"
                     for k, v in worst.items())
          + f" | {_mem(compiled)}", flush=True)
    for k, (diff, t_rel, _) in worst.items():
        check(diff <= 1e-4, f"{k} prim ids differ on {diff}")
        check(t_rel <= 1e-5, f"{k} t rel {t_rel}")
    return worst


def phase_four_cards(size=700, recursion=10, n_devices=4):
    """The sharded path on a 4-card ``rays`` mesh (render pass, GSPMD and
    overlapped train steps) and the prims-sharded render on a 2x2 mesh,
    each compared with the same job on one card.  Times printed here are
    single first calls after compiling (collectives set up on first use),
    not steady-state measurements."""
    from raytracercore.diff import get_material_params
    from raytracercore.parallel import (make_mesh, make_sharded_render_pass,
                                        make_train_step, place_film,
                                        place_scene)
    from raytracercore.parallel.mesh import ray_sharded
    from raytracercore.parallel.shard import (make_overlapped_train_step,
                                              make_prims_sharded_render_pass,
                                              pad_triangles_for_prims)
    from raytracercore.render import camera as cam_mod
    from raytracercore.render.film import Film
    from raytracercore.scene.types import freeze_scene, init_camera

    devices = jax.devices()
    check(len(devices) >= n_devices, f"{len(devices)} devices")
    mesh4 = make_mesh(n_rays=n_devices, devices=devices[:n_devices])
    mesh1 = make_mesh(n_rays=1, devices=devices[:1])
    scene = load_bounce(size, recursion)
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], size, size)
    key = jax.random.PRNGKey(11)
    lines = []

    def spans(a):
        return len(a.sharding.device_set)

    def film_cmp(ref, got):
        rc = np.asarray(ref.color_sum).reshape(-1, 3)
        gc = np.asarray(got.color_sum).reshape(-1, 3)
        close = float(np.all(np.abs(rc - gc) <= 1e-3 + 1e-3 * np.abs(rc),
                             axis=1).mean())
        miss = float((np.asarray(ref.misses)
                      == np.asarray(got.misses)).mean())
        return close, miss

    # Rays laid out on the mesh, as the sharded steps lay them out.
    px, py = cam_mod.pixel_grid(size, size)
    rays = jax.jit(lambda a, b: cam_mod.camera_rays(camera, a, b, key),
                   out_shardings=ray_sharded(mesh4, 2))(px, py)
    check(all(spans(a) == n_devices for a in rays), "rays not on 4 cards")

    # Sharded progressive pass.
    films = {}
    for name, mesh in (("4", mesh4), ("1", mesh1)):
        fn = make_sharded_render_pass(mesh)
        film = place_film(mesh, Film.create(size, size))
        args = (place_scene(mesh, arrays), camera, film, key)
        compiled, t_c = _compile(fn, *args)
        films[name], t_r = _timed(compiled, *args)
        films[name + "t"] = (t_c, t_r)
    check(spans(films["4"].color_sum) == n_devices, "film not on 4 cards")
    close, miss = film_cmp(films["1"], films["4"])
    lines.append(f"sharded render: compile={films['4t'][0]:.2f}s "
                 f"first call={films['4t'][1]:.4f}s "
                 f"(1 card {films['1t'][1]:.4f}s) "
                 f"close={close:.6f} (>=0.999) miss={miss:.6f} (>=0.9999) "
                 f"film spans {spans(films['4'].color_sum)} devices")
    check(close >= 0.999 and miss >= 0.9999, "sharded render vs 1 card")

    # Train steps: gradients captured exactly (see capture_grads).
    cap = capture_grads()
    params = get_material_params(arrays)
    target = jnp.full((size, size, 3), 0.5, jnp.float32)
    single, _ = _compile(make_train_step(None, cap), params, arrays, camera,
                         target, cap.init(params), key)
    (_, g1, l1), t1 = _timed(single, params, arrays, camera, target,
                             cap.init(params), key)
    for name, fn in (("gspmd train step", make_train_step(mesh4, cap)),
                     ("overlapped train step",
                      make_overlapped_train_step(mesh4, cap))):
        tgt = jax.device_put(target, ray_sharded(mesh4, 3))
        args = (params, place_scene(mesh4, arrays), camera, tgt,
                cap.init(params), key)
        compiled, t_c = _compile(fn, *args)
        (_, g4, l4), t_r = _timed(compiled, *args)
        rel = _rel_l2(jax.device_get(g4), jax.device_get(g1))
        loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
        lines.append(f"{name}: compile={t_c:.2f}s first call={t_r:.4f}s "
                     f"(1 card {t1:.4f}s) grad rel L2={rel:.3e} (<=1e-3) "
                     f"loss rel={loss_rel:.3e} (<=1e-4) target spans "
                     f"{spans(tgt)} devices")
        check(rel <= 1e-3 and loss_rel <= 1e-4, f"{name} vs 1 card")

    # Triangle table sharded over ``prims`` on a 2x2 mesh.
    padded = pad_triangles_for_prims(arrays, 2)
    mesh22 = make_mesh(n_rays=2, n_prims=2, devices=devices[:4])
    mesh11 = make_mesh(n_rays=1, n_prims=1, devices=devices[:1])
    pf = {}
    for name, mesh in (("4", mesh22), ("1", mesh11)):
        fn = make_prims_sharded_render_pass(mesh)
        args = (padded, camera, Film.create(size, size), key)
        compiled, t_c = _compile(fn, *args)
        pf[name], t_r = _timed(compiled, *args)
        pf[name + "t"] = (t_c, t_r)
    close, miss = film_cmp(pf["1"], pf["4"])
    lines.append(f"prims-sharded render 2x2: compile={pf['4t'][0]:.2f}s "
                 f"first call={pf['4t'][1]:.4f}s "
                 f"(1 card {pf['1t'][1]:.4f}s) "
                 f"close={close:.6f} (>=0.999) miss={miss:.6f} (>=0.9999) "
                 f"film spans {spans(pf['4'].color_sum)} devices")
    check(close >= 0.999 and miss >= 0.9999, "prims-sharded vs 1 card")
    print(f"(4) four cards: bounce.txt {size}x{size} rec{recursion} | "
          + " | ".join(lines), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform}); nothing run",
              file=sys.stderr)
        return 2
    from raytracercore.config import enable_compile_cache

    enable_compile_cache()
    print(f"card: {card_line()} | jax {jax.__version__} | "
          f"device_kind {dev.device_kind} | devices {len(jax.devices())}",
          flush=True)
    if args.four_cards:
        phase_four_cards()
    else:
        phase_render()
        phase_train()
        phase_bvh()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
