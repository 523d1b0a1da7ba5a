"""Headless CLI — replaces the reference's WinForms shell (MainWindow.cs).

Subcommands:
  render    progressive-render a scene to PNG
  bench     throughput measurement (samples/px/sec, the reference's metric)
  inspect   debug views: primitive-id map, per-pixel bounce traces
  optimize  fit material parameters to a target image (differentiable mode)

Usage: python -m raytracercore.tools.cli render scenes/bounce.txt -o out.png
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(args):
    from ..scene import loader

    scene = loader.from_file(args.scene)
    if scene is None:
        raise SystemExit(f"scene not found: {args.scene}")
    if args.size:
        scene.width = scene.height = args.size
    if args.recursion is not None:
        scene.recursion = args.recursion
    return scene


def cmd_render(args):
    from ..render import Renderer
    from .png import write_png

    scene = _load(args)
    r = Renderer(scene, camera_index=args.camera, seed=args.seed)

    def status(st):
        print(f"spp={st['samples_per_px']} "
              f"{st['samples_per_px_per_sec']:.3f}/px/sec "
              f"progress={st['progress']:.1%}", file=sys.stderr)

    r.run(args.spp, status_cb=status if args.verbose else None)
    write_png(args.output, r.image(exposure=args.exposure))
    print(f"wrote {args.output} ({scene.width}x{scene.height}, "
          f"{args.spp} spp)")


def cmd_bench(args):
    import time

    import jax

    from ..render import Renderer

    scene = _load(args)
    r = Renderer(scene, camera_index=args.camera, seed=args.seed)
    r.step(1)  # compile
    r.reset()
    t0 = time.perf_counter()
    r.step(args.spp)
    dt = time.perf_counter() - t0
    st = r.status()
    print(json.dumps({
        "samples_per_px_per_sec": st["samples_per_px_per_sec"],
        "paths_per_sec": st["paths_per_sec"],
        "elapsed_sec": dt,
        "spp": args.spp,
        "size": [scene.width, scene.height],
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


def cmd_inspect(args):
    from .debug import (bvh_heatmap, primitive_id_map, selection_map,
                        trace_pixel)

    scene = _load(args)
    if args.pixel:
        x, y = (int(v) for v in args.pixel.split(","))
        traces = trace_pixel(scene, x, y, camera_index=args.camera,
                             n_traces=args.traces, seed=args.seed)
        for t_i, bounces in enumerate(traces):
            print(f"trace {t_i}:")
            for b in bounces:
                print("  " + b)
        return
    from .png import write_png
    if args.select:
        img = selection_map(scene, args.select, camera_index=args.camera)
    elif args.mode == "heatmap":
        img = bvh_heatmap(scene, camera_index=args.camera)
    else:
        img = primitive_id_map(scene, camera_index=args.camera)
    write_png(args.output, img)
    print(f"wrote {args.output}")


def cmd_optimize(args):
    import jax
    import jax.numpy as jnp
    import optax

    from ..diff import get_material_params
    from ..parallel import make_train_step
    from ..scene.types import freeze_scene, init_camera
    from .png import read_png

    scene = _load(args)
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[args.camera], scene.width,
                         scene.height)
    target = read_png(args.target)[..., :3].astype(np.float32) / 255.0
    target = jnp.asarray(target) ** 2.2  # undo gamma → linear

    optimizer = optax.adam(args.lr)
    params = get_material_params(arrays)
    opt_state = optimizer.init(params)
    step = make_train_step(None, optimizer)
    key = jax.random.PRNGKey(args.seed)
    for i in range(args.steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, arrays, camera, target,
                                       opt_state, sub)
        if i % 10 == 0:
            print(f"step {i} loss {float(loss):.6f}", file=sys.stderr)
    np.savez(args.output, **{k: np.asarray(v) for k, v in params.items()})
    print(f"wrote {args.output}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracercore")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("scene")
        sp.add_argument("--camera", type=int, default=0)
        sp.add_argument("--size", type=int, default=None,
                        help="override square render size")
        sp.add_argument("--recursion", type=int, default=None)
        sp.add_argument("--seed", type=int, default=0)

    sp = sub.add_parser("render")
    common(sp)
    sp.add_argument("-o", "--output", default="out.png")
    sp.add_argument("--spp", type=int, default=16)
    sp.add_argument("--exposure", type=float, default=1.0)
    sp.add_argument("-v", "--verbose", action="store_true")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("bench")
    common(sp)
    sp.add_argument("--spp", type=int, default=8)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("inspect")
    common(sp)
    sp.add_argument("--pixel", default=None, help="x,y bounce trace")
    sp.add_argument("--traces", type=int, default=4)
    sp.add_argument("--mode", default="prims", choices=["prims", "heatmap"],
                    help="overlay: primitive-id map or BVH heat map")
    sp.add_argument("--select", default=None,
                    help="Selection mode: prim:<id> or node:<index>")
    sp.add_argument("-o", "--output", default="debug.png")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("optimize")
    common(sp)
    sp.add_argument("--target", required=True, help="target PNG")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("-o", "--output", default="materials.npz")
    sp.set_defaults(fn=cmd_optimize)

    args = p.parse_args(argv)
    from ..config import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
