"""Scene loader tests against the two reference scenes.

The counts, materials, transforms and cameras pinned here were derived by
hand from the reference's Scenes/bounce.txt and die.txt and the loader
semantics of its SceneLoader.cs.  The files under scenes/ are
reconstructions written to satisfy exactly these pins.
"""

import numpy as np
import pytest

from raytracercore.scene import loader, types
from raytracercore.scene.types import (HostPlane, HostSphere,
                                       HostTriangle, freeze_scene)


def test_bounce_counts(bounce_txt):
    scene = loader.parse(bounce_txt)
    # light box "not -z" (5 quads) + room cube via 6 `instance` commands
    # (a bare `cube` with no side option emits NOTHING — the implicit
    # instance resolves to zero sides, SceneLoader.cs:355, Cube.cs:22-26)
    # + corner cutout "only +x -y" (2) + rotated cube all (6) = 19 quads;
    # diffuse sphere + lens sphere + mirror sphere = 3 spheres.
    tris = scene.triangles
    spheres = scene.spheres
    assert len(tris) == 19
    assert len(spheres) == 3
    assert len(scene.planes) == 0
    assert len(scene.primitives) == 22
    assert scene.width == 700 and scene.height == 700
    assert scene.recursion == 10  # later `recursion 10` overrides 20
    assert len(scene.cameras) == 8
    assert scene.ambient_rgb is not None  # default black, not miss
    np.testing.assert_allclose(scene.ambient_rgb, 0.0)


def test_bounce_light_box_material(bounce_txt):
    scene = loader.parse(bounce_txt)
    # First 5 primitives are the emissive light box quads.
    for prim in scene.primitives[:5]:
        assert isinstance(prim, HostTriangle)
        np.testing.assert_allclose(prim.material.emission, [5, 5, 5])
        np.testing.assert_allclose(prim.material.diffuse, [0, 0, 0])
        np.testing.assert_allclose(prim.material.specular, [0, 0, 0])
        assert prim.material.two_sided is True
        assert prim.material.invert is False


def test_bounce_room_material(bounce_txt):
    scene = loader.parse(bounce_txt)
    # Primitives 5..10 are the six room-wall instances
    # (invert true, twosided false).
    room = scene.primitives[5:11]
    for prim in room:
        assert prim.material.invert is True
        assert prim.material.two_sided is False
        np.testing.assert_allclose(prim.material.emission, 0.0)
    for prim in room[:5]:
        assert prim.material.shininess == 250
    # Floor instance gets shininess 1e3 and blue-ish diffuse.
    assert room[5].material.shininess == 1e3
    np.testing.assert_allclose(room[5].material.diffuse, [0.4, 0.4, 0.9])
    # instance -y is the close-right green wall.
    np.testing.assert_allclose(room[0].material.diffuse, [0.1, 1.0, 0.1])


def test_bounce_lens_sphere(bounce_txt):
    scene = loader.parse(bounce_txt)
    spheres = scene.spheres
    lens = spheres[1]
    np.testing.assert_allclose(lens.material.refraction, [0.9, 0.9, 0.9])
    assert lens.material.refractive_index == 1.52
    assert lens.material.shininess == 1e5
    np.testing.assert_allclose(lens.material.specular, [0.9, 0.9, 0.9])
    np.testing.assert_allclose(lens.material.diffuse, [0.0, 0.0, 0.0])
    assert lens.transformed
    # Transform: translate(1,-1.25,-.5) ∘ rotate(z,-45°) ∘ scale(.25,1,1);
    # obj→world maps object-space origin to the translate offset.
    np.testing.assert_allclose(
        lens.obj_to_world[:3, :3] @ np.zeros(3) + lens.obj_to_world[:3, 3],
        [1, -1.25, -0.5], atol=1e-12)
    # world_to_obj must be the exact inverse.
    np.testing.assert_allclose(
        lens.obj_to_world @ lens.world_to_obj, np.eye(4), atol=1e-12)

    mirror = spheres[2]
    assert mirror.material.shininess == 1e6
    np.testing.assert_allclose(mirror.material.specular, [0.9, 0.9, 0.9])
    assert mirror.material.refractive_index == -1.0 or \
        mirror.material.refraction.sum() == 0  # refraction off before it


def test_bounce_rotated_cube_transform(bounce_txt):
    scene = loader.parse(bounce_txt)
    # Rotated cube: translate(1.25,0,0) rotate(z,45°), cube at 0 0 -.375.
    # Its 6 quads are primitives 14..19; centroid mean of all its corners
    # should be the transformed cube center.
    quads = scene.primitives[14:20]
    corners = []
    for q in quads:
        corners.extend([q.v0, q.v1, q.v2, q.v0 + q.edge01 + q.edge02])
    center = np.mean(corners, axis=0)
    np.testing.assert_allclose(center, [1.25, 0, -0.375], atol=1e-12)


def test_die_counts(die_txt):
    scene = loader.parse(die_txt)
    assert len(scene.spheres) == 23  # 2 lights + 21 pips
    # Bare `cube` emits nothing; the die faces come from the 6 instances.
    assert len(scene.triangles) == 6
    assert scene.width == 1280 and scene.height == 960
    assert len(scene.cameras) == 3
    assert scene.ambient_rgb is not None
    # dof .1 1000 to 3 applies to all three cameras
    for cam in scene.cameras:
        assert cam.image_plane == 0.1
        assert cam.dof_amount == 1000
        assert cam.focal_length == 3


def test_die_light_materials(die_txt):
    scene = loader.parse(die_txt)
    lights = scene.spheres[:2]
    np.testing.assert_allclose(lights[0].material.emission, [10, 8, 8])
    np.testing.assert_allclose(lights[1].material.emission, [8, 8, 10])
    # specular 0 0 0 set before lights
    np.testing.assert_allclose(lights[0].material.specular, 0.0)
    # Pip spheres share diffuse .9 .9 .9 / specular .5 .5 .5
    pip = scene.spheres[5]
    np.testing.assert_allclose(pip.material.diffuse, [0.9, 0.9, 0.9])
    np.testing.assert_allclose(pip.material.specular, [0.5, 0.5, 0.5])


def test_camera_finalize_focal_length(bounce_txt):
    scene = loader.parse(bounce_txt)
    cam = scene.cameras[0]
    # No dof command in bounce.txt ⇒ focal = |lookAt - position|.
    expected = np.linalg.norm(np.array([0, 0, -1.0]) - cam.position)
    assert abs(cam.focal_length - expected) < 1e-12
    assert cam.image_plane == 0 and cam.dof_amount == 0


def test_unknown_commands_skipped(bounce_txt):
    # bounce.txt contains `output` and `point` commands — must not raise.
    loader.parse(bounce_txt)


def test_loader_error_context():
    with pytest.raises(loader.LoaderError) as exc:
        loader.parse("sphere 0 0\n")
    assert exc.value.command == "sphere"
    assert exc.value.line == 1


def test_freeze_shapes(bounce_txt):
    scene = loader.parse(bounce_txt)
    arrays = freeze_scene(scene)
    # Tables are exact-sized by default (pad=1 in freeze_scene): every row
    # is a real primitive, no padding rows.
    n_tris = int((arrays.triangles.prim_id >= 0).sum())
    assert arrays.triangles.v0.shape[0] == n_tris
    assert n_tris == 19
    assert int((arrays.spheres.prim_id >= 0).sum()) == 3
    assert int((arrays.planes.prim_id >= 0).sum()) == 0
    assert arrays.materials.emission.shape == (22, 3)
    assert arrays.n_prims == 22
    assert arrays.recursion == 10
    # Specular gating: shininess>0 everywhere here, so specular kept.
    assert float(arrays.materials.specular.max()) == pytest.approx(0.9,
                                                                   abs=1e-6)


def test_freeze_camera(bounce_txt):
    scene = loader.parse(bounce_txt)
    cam = types.init_camera(scene.cameras[0], scene.width, scene.height)
    # Basis is orthonormal.
    import numpy as np
    for v in (cam.look, cam.side, cam.up):
        assert abs(np.linalg.norm(np.asarray(v)) - 1) < 1e-6
    assert abs(float(np.asarray(cam.look) @ np.asarray(cam.side))) < 1e-6
    assert abs(float(np.asarray(cam.look) @ np.asarray(cam.up))) < 1e-6
    assert cam.mode == 0


def test_sticky_materials_and_stack():
    text = """
size 8 8
diffuse 1 0 0
pushtransform
translate 1 2 3
sphere 0 0 0 2
poptransform
sphere 5 0 0 1
"""
    scene = loader.parse(text)
    a, b = scene.spheres
    np.testing.assert_allclose(a.material.diffuse, [1, 0, 0])
    np.testing.assert_allclose(b.material.diffuse, [1, 0, 0])
    assert a.transformed
    assert not b.transformed
    np.testing.assert_allclose(
        a.obj_to_world[:3, 3], [1, 2, 3], atol=1e-15)


def test_shininess_exponent_form():
    scene = loader.parse("shininess 10 3\nsphere 0 0 0 1\n")
    assert scene.spheres[0].material.shininess == 1000


def test_plane_command_and_transform():
    scene = loader.parse(
        "pushtransform\ntranslate 0 0 5\nplane 2 0 0 1\npoptransform\n")
    pl = scene.planes[0]
    np.testing.assert_allclose(pl.normal, [0, 0, 1], atol=1e-15)
    # Plane at distance 2 along +z, translated +5 along z ⇒ distance 7.
    assert abs(pl.origin_distance - 7.0) < 1e-12
