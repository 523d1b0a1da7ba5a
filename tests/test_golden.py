"""Fixed-RNG golden regression: the forward render must not drift.

The committed arrays (tests/golden/films.npz, regenerated only on purpose by
scripts/make_golden.py) pin the film state of small bounce.txt / die.txt
renders at seed 0 on the CPU backend.  The scenes are the in-repo
reconstructions under scenes/.

Tolerances are loose enough to survive XLA version-to-version reassociation
but tight enough that any semantic change to camera rays, RNG consumption
order, intersection, or shading fails loudly.
"""

import pathlib

import numpy as np
import pytest

from raytracercore.config import SCENES_DIR
from raytracercore.render.renderer import Renderer
from raytracercore.scene import loader

GOLDEN = pathlib.Path(__file__).parent / "golden" / "films.npz"

CONFIGS = {
    # name: (scene file, width, height, spp, camera) — mirror make_golden.py
    "bounce": ("bounce.txt", 64, 64, 8, 0),
    "die": ("die.txt", 48, 36, 4, 0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_film(name):
    fname, w, h, spp, cam = CONFIGS[name]
    scene = loader.from_file(str(SCENES_DIR / fname))
    scene.width, scene.height = w, h
    r = Renderer(scene, camera_index=cam, seed=0)
    r.step(spp)
    data = np.load(GOLDEN)

    samples = np.asarray(r.film.samples)
    misses = np.asarray(r.film.misses)
    color = np.asarray(r.film.color_sum)
    # Sample/miss counts are integer-valued and RNG-determined: exact.
    np.testing.assert_array_equal(samples, data[f"{name}_samples"])
    np.testing.assert_array_equal(misses, data[f"{name}_misses"])
    # Color sums: identical paths, f32 math — allow reassociation noise.
    ref = data[f"{name}_color_sum"]
    np.testing.assert_allclose(color, ref, rtol=1e-4, atol=1e-4)
    # Guard against a vacuously-black golden.
    assert ref.max() > 1.0
