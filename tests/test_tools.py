"""Tools tests: PNG IO, debug raycaster views, bounce-trace inspector, CLI."""

import numpy as np

from raytracercore.config import SCENES_DIR
from raytracercore.scene import loader
from raytracercore.tools import debug, png


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for c in (3, 4):
        img = rng.integers(0, 256, size=(13, 17, c), dtype=np.uint8)
        path = str(tmp_path / f"t{c}.png")
        png.write_png(path, img)
        back = png.read_png(path)
        np.testing.assert_array_equal(back, img)


def test_primitive_id_map(bounce_txt):
    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 24
    img = debug.primitive_id_map(scene, camera_index=0)
    assert img.shape == (24, 24, 3)
    # Some pixels hit (non-black), some miss (black) from camera 0.
    flat = img.reshape(-1, 3)
    assert (flat.sum(-1) == 0).any()
    assert (flat.sum(-1) > 0).any()
    # Multiple distinct primitives visible.
    assert len(np.unique(flat, axis=0)) > 3


def test_trace_pixel_bounce_listing(bounce_txt):
    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 24
    traces = debug.trace_pixel(scene, 12, 12, n_traces=3, seed=1)
    assert len(traces) == 3
    for lines in traces:
        assert lines  # at least the color summary
        assert lines[-1].startswith("color=")
        # Tags must come from the BounceType vocabulary.
        for ln in lines[:-1]:
            tag = ln.split()[0]
            from raytracercore.render.integrator import BounceType
            assert tag in BounceType.NAMES


def test_cli_render_and_inspect(tmp_path, monkeypatch):
    from raytracercore.tools import cli

    out = str(tmp_path / "r.png")
    cli.main(["render", str(SCENES_DIR / "bounce.txt"), "--size", "16",
              "--spp", "2", "--recursion", "3", "-o", out])
    img = png.read_png(out)
    assert img.shape == (16, 16, 4)

    out2 = str(tmp_path / "ids.png")
    cli.main(["inspect", str(SCENES_DIR / "bounce.txt"), "--size", "16",
              "-o", out2])
    assert png.read_png(out2).shape == (16, 16, 3)


def test_selection_map_prim(bounce_txt):
    # Selection mode (DebugRaycaster.cs:21-78): only the selected primitive
    # is intersected; the overlay must be a subset of that prim's id-map
    # pixels but can be LARGER than the visible set (occluders are ignored).
    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 24
    ids = debug.primitive_id_map(scene, camera_index=0)

    # Pick a primitive that is visible from camera 0.
    import jax
    from raytracercore.intersect import closest_hit
    from raytracercore.scene.types import freeze_scene
    arrays = freeze_scene(scene)
    o, d = debug._center_rays(scene, 0)
    hit = jax.jit(closest_hit)(arrays, o, d, None)
    prims = np.asarray(hit.prim)
    sel = int(prims[prims >= 0][0])

    overlay = debug.selection_map(scene, f"prim:{sel}", camera_index=0)
    assert overlay.shape == (24, 24, 4)
    mask = overlay[..., 3] == 255
    vis = prims.reshape(24, 24) == sel
    # Every visible pixel of the prim is in the overlay...
    assert (mask | ~vis).all()
    assert mask.sum() >= vis.sum() > 0
    # ...and colored with the id-rotation color where visible.
    np.testing.assert_array_equal(overlay[vis][:, :3], ids[vis])


def test_selection_map_node(bounce_txt):
    scene = loader.parse(bounce_txt)
    scene.width = scene.height = 24
    overlay = debug.selection_map(scene, "node:0", camera_index=0)
    # Root node AABB covers everything the id map shows.
    ids = debug.primitive_id_map(scene, camera_index=0)
    hit_any = ids.sum(-1) > 0
    mask = overlay[..., 3] == 255
    assert (mask | ~hit_any).all()
    assert mask.sum() > 0
