"""Scene text-format loader.

Parses the reference's line-oriented command format with identical semantics
(``RaytracerCore/SceneLoader.cs:28-442``):

* **Sticky material state** — twosided/invert/emission/diffuse/specular/
  shininess/refraction apply to every primitive emitted after them
  (SceneLoader.cs:131-139, 388-413).
* **Matrix stack** — transforms accumulate on a stack mirrored by an
  incrementally-built inverse stack so no inversion is computed
  (SceneLoader.cs:274-297, MatrixStack.cs:27-30); transforms are baked into
  primitives at creation (SceneLoader.cs:410).
* **Unknown commands are logged and skipped** (SceneLoader.cs:367-369) — the
  shipped scenes rely on this (`output`, `point`, `directional`).

The output is a :class:`~raytracercore.scene.types.HostScene`; call
``freeze_scene`` to obtain device arrays.
"""

from __future__ import annotations

import logging
import math
import os
from typing import List, Optional

import numpy as np

from . import transforms as T
from .objects import ALL_SIDES, NO_SIDES, Cube, get_side
from .types import (HostCamera, HostPlane, HostScene, HostSphere,
                    HostTriangle, Material)

log = logging.getLogger(__name__)


class LoaderError(Exception):
    """Parse failure with command + line context (SceneLoader.cs:16-26)."""

    def __init__(self, command: str, line: int, cause: Exception):
        super().__init__(
            f"Error while parsing command {command} on line {line}: {cause}")
        self.command = command
        self.line = line
        self.cause = cause


class _Params:
    """Parameter cursor over one command's tokens (SceneLoader.cs:42-110)."""

    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._tokens)

    def next(self) -> str:
        if not self.has_next():
            raise IndexError("A parameter was missing from a command.")
        tok = self._tokens[self._i]
        self._i += 1
        return tok

    def next_dbl(self) -> float:
        return float(self.next())

    def next_int(self) -> int:
        return int(self.next())

    def next_vec(self) -> np.ndarray:
        return np.array(
            [self.next_dbl(), self.next_dbl(), self.next_dbl()],
            dtype=np.float64)

    def next_rgb(self) -> np.ndarray:
        return self.next_vec()

    def next_bool(self) -> bool:
        return self.next() in ("1", "true", "yes", "y")

    def read_all(self) -> List[str]:
        out = self._tokens[self._i:]
        self._i = len(self._tokens)
        return out


def _tokenize(line: str) -> List[str]:
    """Split a line into command + params; ``#`` starts a comment and commas
    act as separators (the lineRegex, SceneLoader.cs:38-40)."""
    hash_pos = line.find("#")
    if hash_pos >= 0:
        line = line[:hash_pos]
    return line.replace(",", " ").split()


def parse(text: str) -> HostScene:
    """Parse scene text into a HostScene (SceneLoader.FromFile body,
    SceneLoader.cs:112-428)."""
    scene = HostScene()

    # Camera DoF state — sticky, applied to every subsequent camera
    # (SceneLoader.cs:122-126, 372-386).
    image_plane = 0.0
    dof_amount = 0.0
    focal_length = 0.0
    focal_point: Optional[np.ndarray] = None

    # Sticky material state (SceneLoader.cs:131-139).
    two_sided = True
    invert = False
    emission: Optional[np.ndarray] = None
    diffuse: Optional[np.ndarray] = None
    specular: Optional[np.ndarray] = None
    shininess = -1.0
    refraction: Optional[np.ndarray] = None
    refraction_index = -1.0

    stack = T.MatrixStack()
    inv_stack = T.MatrixStack()

    vertices: List[np.ndarray] = []
    vertex_normals: List[tuple] = []

    obj: Optional[Cube] = None

    for line_num, raw in enumerate(text.splitlines(), start=1):
        tokens = _tokenize(raw)
        if not tokens:
            continue
        cmd = tokens[0].lower()
        p = _Params(tokens[1:])

        add_cam: Optional[HostCamera] = None
        prims: list = []

        try:
            if cmd == "size":
                scene.width = p.next_int()
                scene.height = p.next_int()
            elif cmd == "background":
                scene.background_rgb = p.next_rgb()
                scene.background_alpha = p.next_dbl()
            elif cmd == "ambient":
                kind = p.next()
                if kind == "miss":
                    scene.ambient_rgb = None
                elif kind == "color":
                    scene.ambient_rgb = p.next_rgb()
                else:
                    raise ValueError(f"Unknown ambient type {kind}.")
            elif cmd in ("recursion", "bounce"):
                scene.recursion = p.next_int()
            elif cmd == "debug":
                kind = p.next()
                if kind == "geom":
                    scene.debug_geom = True
                elif kind == "off":
                    scene.debug_geom = False
                else:
                    raise ValueError(f"Unknown debug type {kind}.")
            # Cameras -----------------------------------------------------
            elif cmd == "dof":
                image_plane = p.next_dbl()
                dof_amount = p.next_dbl()
                focal_cmd = p.next()
                if focal_cmd == "at":
                    focal_point = T.transform_point(stack.peek(), p.next_vec())
                    focal_length = 0.0
                elif focal_cmd == "to":
                    focal_length = p.next_dbl()
                    focal_point = None
                elif focal_cmd == "camera":
                    focal_length = 0.0
                    focal_point = None
                else:
                    raise ValueError(
                        f"Unknown dof focal command {focal_cmd}.")
            elif cmd in ("camera", "frustum", "orthographic"):
                pos = p.next_vec()
                look_at = p.next_vec()  # NOT transformed (SceneLoader.cs:230)
                up = T.transform_point(stack.peek(), p.next_vec() + pos)
                pos = T.transform_point(stack.peek(), pos)
                up = up - pos
                mode = "ortho" if cmd == "orthographic" else "frustum"
                fov_or_size = p.next_dbl()
                if mode == "frustum":
                    fov_or_size = math.radians(fov_or_size)
                add_cam = HostCamera(mode=mode, position=pos,
                                     look_at=look_at, up=up,
                                     fov_or_size=fov_or_size)
            # Materials ---------------------------------------------------
            elif cmd == "twosided":
                two_sided = p.next_bool()
            elif cmd == "invert":
                invert = p.next_bool()
            elif cmd == "emission":
                emission = p.next_rgb()
            elif cmd == "diffuse":
                diffuse = p.next_rgb()
            elif cmd == "specular":
                specular = p.next_rgb()
            elif cmd == "shininess":
                shininess = p.next_dbl()
                if p.has_next():
                    shininess = shininess ** p.next_dbl()
            elif cmd == "refraction":
                first = p.next()
                if first == "off":
                    refraction = None
                    refraction_index = -1.0
                else:
                    refraction = np.array(
                        [float(first), p.next_dbl(), p.next_dbl()],
                        dtype=np.float64)
                    refraction_index = p.next_dbl()
            # Transforms --------------------------------------------------
            elif cmd == "translate":
                v = p.next_vec()
                stack.transform(T.translate(v[0], v[1], v[2]))
                inv_stack.inv_transform(T.translate(-v[0], -v[1], -v[2]))
            elif cmd == "scale":
                v = p.next_vec()
                stack.transform(T.scale(v[0], v[1], v[2]))
                inv_stack.inv_transform(
                    T.scale(1.0 / v[0], 1.0 / v[1], 1.0 / v[2]))
            elif cmd == "rotate":
                axis = p.next_vec()
                axis = axis / np.linalg.norm(axis)
                angle = math.radians(p.next_dbl())
                stack.transform(T.rotate(angle, axis))
                inv_stack.inv_transform(T.rotate(-angle, axis))
            elif cmd == "pushtransform":
                stack.push()
                inv_stack.push()
            elif cmd == "poptransform":
                stack.pop()
                inv_stack.pop()
            # Primitives --------------------------------------------------
            elif cmd == "sphere":
                prims.append(HostSphere(center=p.next_vec(),
                                        radius=p.next_dbl()))
            elif cmd == "plane":
                dist = p.next_dbl()
                normal = p.next_vec()
                normal = normal / np.linalg.norm(normal)
                prims.append(HostPlane(normal=normal, origin_distance=dist))
            elif cmd == "vertex":
                vertices.append(p.next_vec())
            elif cmd == "tri":
                v0 = vertices[p.next_int()]
                v1 = vertices[p.next_int()]
                v2 = vertices[p.next_int()]
                mirror = p.has_next() and p.next() == "mirrored"
                prims.append(HostTriangle(v0=v0.copy(), v1=v1.copy(),
                                          v2=v2.copy(), mirror=mirror))
            elif cmd == "vertexnormal":
                pos = p.next_vec()
                nrm = p.next_vec()
                vertex_normals.append((pos, nrm / np.linalg.norm(nrm)))
            elif cmd == "trinormal":
                a = vertex_normals[p.next_int()]
                b = vertex_normals[p.next_int()]
                c = vertex_normals[p.next_int()]
                prims.append(HostTriangle(
                    v0=a[0].copy(), v1=b[0].copy(), v2=c[0].copy(),
                    has_normals=True,
                    n0=a[1].copy(), n1=b[1].copy(), n2=c[1].copy()))
            # Objects -----------------------------------------------------
            elif cmd == "cube":
                pos = p.next_vec()
                size = p.next_vec()
                cube = Cube(pos, size)
                obj = cube
                if p.has_next():
                    opt = p.next()
                    if opt == "all":
                        prims.extend(cube.get_children(ALL_SIDES))
                    elif opt == "only":
                        sides = NO_SIDES
                        for name in p.read_all():
                            sides |= get_side(name)
                        prims.extend(cube.get_children(sides))
                    elif opt == "not":
                        sides = ALL_SIDES
                        for name in p.read_all():
                            sides &= ~get_side(name)
                        prims.extend(cube.get_children(sides))
                    else:
                        raise ValueError(
                            "Unknown option provided for cube construction: "
                            + opt)
                # The implicit instance adds nothing for cubes
                # (SceneLoader.cs:355, Cube.GetSide("implicit") == 0).
            elif cmd == "instance":
                if obj is None:
                    raise ValueError("instance command with no object defined")
                for name in p.read_all():
                    prims.extend(obj.get_children_named(name))
            elif cmd in ("maxverts", "maxvertnorms"):
                pass
            else:
                log.warning("Unknown command: %s", cmd)
        except Exception as e:  # noqa: BLE001 — wrap with context
            raise LoaderError(cmd, line_num, e) from e

        # Camera finalize (SceneLoader.cs:372-386).
        if add_cam is not None:
            add_cam.image_plane = image_plane
            add_cam.dof_amount = dof_amount
            if focal_point is not None and not np.array_equal(
                    focal_point, np.zeros(3)):
                add_cam.focal_length = float(
                    np.linalg.norm(focal_point - add_cam.position))
            elif focal_length != 0.0:
                add_cam.focal_length = focal_length
            else:
                add_cam.focal_length = float(
                    np.linalg.norm(add_cam.look_at - add_cam.position))
            scene.cameras.append(add_cam)

        # Sticky-material application + transform baking
        # (SceneLoader.cs:388-413).
        for prim in prims:
            m = prim.material
            m.two_sided = two_sided
            m.invert = invert
            if emission is not None:
                m.emission = emission.copy()
            if diffuse is not None:
                m.diffuse = diffuse.copy()
            if specular is not None:
                m.specular = specular.copy()
            if shininess != -1.0:
                m.shininess = shininess
            if refraction is not None:
                m.refraction = refraction.copy()
                m.refractive_index = refraction_index
            prim.transform(stack.peek(), inv_stack.peek())
            scene.add_primitive(prim)

    return scene


def from_file(path: str | os.PathLike) -> HostScene:
    with open(path, "r", encoding="utf-8-sig") as fh:
        return parse(fh.read())
