"""Worker process for the 2-process CPU multi-host test / demo.

Each process owns 4 virtual CPU devices; the global mesh spans 8 devices
across both processes.  Renders bounce.txt sharded over the global rays
axis, gathers the film, and process 0 writes the result.

Usage (launched by tests/test_multihost.py or by hand, one per shell):
    python scripts/multihost_worker.py <pid> <nprocs> <port> <out.npz>
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    pid, nprocs, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    from raytracercore.parallel.distributed import (gather_film,
                                                    init_distributed)

    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs
    n_global = len(jax.devices())
    assert n_global == 4 * nprocs, n_global

    import jax.numpy as jnp

    from raytracercore.parallel.mesh import make_mesh
    from raytracercore.parallel.shard import (make_sharded_render_pass,
                                              place_film, place_scene)
    from raytracercore.config import SCENES_DIR
    from raytracercore.render.film import Film
    from raytracercore.scene import loader
    from raytracercore.scene.types import freeze_scene, init_camera

    scene = loader.from_file(str(SCENES_DIR / "bounce.txt"))
    scene.width = scene.height = 32
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], 32, 32)

    mesh = make_mesh()
    arrays = place_scene(mesh, arrays)
    camera = place_scene(mesh, camera)
    film = place_film(mesh, Film.create(32, 32))

    render = make_sharded_render_pass(mesh)
    key = jax.random.PRNGKey(0)
    for i in range(2):
        film = render(arrays, camera, film, jax.random.fold_in(key, i))

    host = gather_film(film)
    if pid == 0:
        np.savez(out, color_sum=host.color_sum, samples=host.samples,
                 misses=host.misses)
        print("saved", out, "mean", float(host.color_sum.mean()), flush=True)
    # All processes exit together (allgather above is already a barrier).


if __name__ == "__main__":
    main()
