"""Regenerate the committed fixed-RNG golden arrays for tests/test_golden.py.

Run on CPU (the test environment) so the goldens match the backend tests run
on:

    JAX_PLATFORMS=cpu python scripts/make_golden.py

Regenerate ONLY when an intentional change to the forward path alters the
image; the diff of the goldens is then the review artifact.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, ".")

# The config update below wins even if jax was imported first, as long as
# no op has run yet (see tests/conftest).
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

CONFIGS = [
    # (name, scene, width, height, spp, camera)
    ("bounce", "bounce.txt", 64, 64, 8, 0),
    ("die", "die.txt", 48, 36, 4, 0),
]


def render_film(scene_file, w, h, spp, cam):
    from raytracercore.config import SCENES_DIR
    from raytracercore.render.renderer import Renderer
    from raytracercore.scene import loader

    scene = loader.from_file(str(SCENES_DIR / scene_file))
    scene.width, scene.height = w, h
    r = Renderer(scene, camera_index=cam, seed=0)
    r.step(spp)
    return r.film


def main():
    assert jax.default_backend() == "cpu", "goldens are CPU-generated"
    out = {}
    for name, path, w, h, spp, cam in CONFIGS:
        film = render_film(path, w, h, spp, cam)
        out[f"{name}_color_sum"] = np.asarray(film.color_sum)
        out[f"{name}_samples"] = np.asarray(film.samples)
        out[f"{name}_misses"] = np.asarray(film.misses)
        print(name, "mean color", out[f"{name}_color_sum"].mean())
    np.savez_compressed("tests/golden/films.npz", **out)
    print("wrote tests/golden/films.npz")


if __name__ == "__main__":
    main()
