"""Multi-process (2-host analog) rendering: two OS processes, 4 virtual CPU
devices each, one global 8-device mesh — sharded render must equal the
single-process result (SURVEY §5.8; the reference has no cross-process
anything).
"""

import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "scripts" / "multihost_worker.py"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    out = tmp_path / "film.npz"
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port),
             str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO))
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    assert out.exists()
    got = np.load(out)

    # Single-process oracle: same scene, same keys, unsharded.
    from raytracercore.config import SCENES_DIR
    from raytracercore.render.film import Film
    from raytracercore.render.renderer import render_pass
    from raytracercore.scene import loader
    from raytracercore.scene.types import freeze_scene, init_camera

    scene = loader.from_file(str(SCENES_DIR / "bounce.txt"))
    scene.width = scene.height = 32
    arrays = freeze_scene(scene)
    camera = init_camera(scene.cameras[0], 32, 32)
    film = Film.create(32, 32)
    key = jax.random.PRNGKey(0)
    for i in range(2):
        film = render_pass(arrays, camera, film, jax.random.fold_in(key, i))

    np.testing.assert_array_equal(got["samples"], np.asarray(film.samples))
    np.testing.assert_array_equal(got["misses"], np.asarray(film.misses))
    np.testing.assert_allclose(got["color_sum"],
                               np.asarray(film.color_sum),
                               rtol=2e-5, atol=2e-5)
    assert got["color_sum"].max() > 0.5
