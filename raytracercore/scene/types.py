"""Scene data model: host-side records and the frozen SoA device arrays.

The reference keeps an object graph (``Scene`` holding ``Primitive`` subclasses,
each owning its material — Raytracing/Scene.cs:14-35,
Raytracing/Primitives/Primitive.cs:14-133).  This build splits it into:

* **Host records** (plain Python dataclasses, numpy f64) produced by the
  loader, mutated while transforms/materials are baked.
* **``SceneArrays``** — a frozen SoA pytree of jnp arrays, one table per
  primitive type plus a unified material table indexed by global primitive id.
  Tables are padded to a static size so every shape under ``jit`` is static;
  padding rows carry ``prim_id == -1`` and are masked out by the intersectors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field

from . import transforms as T

AIR_REFRACTIVE_INDEX = 1.000293  # Scene.cs:35


# ---------------------------------------------------------------------------
# Host-side records (numpy, f64)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Material:
    """Per-primitive material record (Primitive.cs:96-133).

    Defaults mirror the Primitive constructor (Primitive.cs:23-32):
    all colors black, shininess 100, refractive index 0.
    """

    emission: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    diffuse: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    specular: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    refraction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    refractive_index: float = 0.0
    shininess: float = 100.0
    two_sided: bool = False
    invert: bool = False


@dataclasses.dataclass
class HostTriangle:
    """Triangle / mirrored-quad (Primitives/Triangle.cs:11-74).

    ``mirror=True`` turns the UV test into ``v <= 1`` making the primitive a
    parallelogram (Triangle.cs:118,167).  ``has_normals`` selects smooth
    shading (barycentric-interpolated vertex normals, Triangle.cs:209-224).
    """

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    mirror: bool = False
    has_normals: bool = False
    n0: Optional[np.ndarray] = None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None
    material: Material = dataclasses.field(default_factory=Material)

    def transform(self, forward: np.ndarray, inverse: np.ndarray) -> None:
        # Vertex.Transformed applies the forward matrix to positions and (for
        # smooth triangles) to normals, re-normalizing (Vertex.cs:25-28).
        self.v0 = T.transform_point(forward, self.v0)
        self.v1 = T.transform_point(forward, self.v1)
        self.v2 = T.transform_point(forward, self.v2)
        if self.has_normals:
            for attr in ("n0", "n1", "n2"):
                n = T.transform_dir(forward, getattr(self, attr))
                setattr(self, attr, n / np.linalg.norm(n))

    @property
    def edge01(self) -> np.ndarray:
        return self.v1 - self.v0

    @property
    def edge02(self) -> np.ndarray:
        return self.v2 - self.v0

    @property
    def face_normal(self) -> np.ndarray:
        n = np.cross(self.edge01, self.edge02)
        return n / np.linalg.norm(n)


@dataclasses.dataclass
class HostSphere:
    """Sphere with optional affine transform → ellipsoid
    (Primitives/Sphere.cs:10-48).

    ``obj_to_world`` is the reference's ``MatrixToObject`` and
    ``world_to_obj`` its ``MatrixToWorld`` (the reference names are inverted
    relative to what they do; we use direction-of-application names).
    """

    center: np.ndarray
    radius: float
    obj_to_world: np.ndarray = dataclasses.field(default_factory=T.identity)
    world_to_obj: np.ndarray = dataclasses.field(default_factory=T.identity)
    transformed: bool = False
    material: Material = dataclasses.field(default_factory=Material)

    def transform(self, forward: np.ndarray, inverse: np.ndarray) -> None:
        # Sphere.Transform (Sphere.cs:29-37).
        if not np.array_equal(forward, T.identity()):
            self.transformed = True
        self.obj_to_world = self.obj_to_world @ forward
        self.world_to_obj = inverse @ self.world_to_obj

    @property
    def normal_matrix(self) -> np.ndarray:
        return T.transpose3x3(self.world_to_obj)


@dataclasses.dataclass
class HostPlane:
    """Infinite plane {normal, origin_distance} (Primitives/Plane.cs:11-34)."""

    normal: np.ndarray
    origin_distance: float
    material: Material = dataclasses.field(default_factory=Material)

    def transform(self, forward: np.ndarray, inverse: np.ndarray) -> None:
        # Plane.Transform (Plane.cs:30-35).
        center = T.transform_point(
            forward, self.normal * self.origin_distance)
        n = T.transpose3x3(inverse)[:3, :3] @ self.normal
        self.normal = n / np.linalg.norm(n)
        self.origin_distance = float(center @ self.normal)


@dataclasses.dataclass
class HostCamera:
    """Camera definition (Cameras/Camera.cs:8-81).

    ``mode``: "frustum" (perspective pinhole) or "ortho".
    ``fov_or_size``: vertical FOV in radians (frustum) or size multiplier
    (ortho).  DoF state per SceneLoader.cs:203-225, 372-386.
    """

    mode: str
    position: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    fov_or_size: float
    image_plane: float = 0.0
    dof_amount: float = 0.0
    focal_length: float = 0.0


@dataclasses.dataclass
class HostScene:
    """Mutable scene under construction (Scene.cs:14-63)."""

    width: int = 0
    height: int = 0
    background_rgb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    background_alpha: float = 0.0
    # None ⇒ "ambient miss": secondary misses count as miss samples
    # (the Placeholder sentinel, SceneLoader.cs:182-189).  Default black.
    ambient_rgb: Optional[np.ndarray] = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    recursion: int = 3
    debug_geom: bool = False
    air_refractive_index: float = AIR_REFRACTIVE_INDEX
    cameras: List[HostCamera] = dataclasses.field(default_factory=list)
    primitives: list = dataclasses.field(default_factory=list)

    def add_primitive(self, prim) -> None:
        self.primitives.append(prim)

    @property
    def triangles(self) -> List[HostTriangle]:
        return [p for p in self.primitives if isinstance(p, HostTriangle)]

    @property
    def spheres(self) -> List[HostSphere]:
        return [p for p in self.primitives if isinstance(p, HostSphere)]

    @property
    def planes(self) -> List[HostPlane]:
        return [p for p in self.primitives if isinstance(p, HostPlane)]


# ---------------------------------------------------------------------------
# Frozen device-side SoA (pytree dataclasses)
# ---------------------------------------------------------------------------

class Materials(PyTreeNode):
    """Unified material table, row = global primitive id.

    The ``IsReflective ⇒ Shininess > 0`` gating of specular/refraction
    (Primitive.cs:111-128) is baked in at freeze time.
    """

    emission: jnp.ndarray        # [N, 3]
    diffuse: jnp.ndarray         # [N, 3]
    specular: jnp.ndarray        # [N, 3]
    refraction: jnp.ndarray      # [N, 3]
    refractive_index: jnp.ndarray  # [N]
    shininess: jnp.ndarray       # [N]
    two_sided: jnp.ndarray       # [N] bool
    invert: jnp.ndarray          # [N] bool


class Triangles(PyTreeNode):
    v0: jnp.ndarray       # [T, 3]
    e1: jnp.ndarray       # [T, 3]  edge 0→1
    e2: jnp.ndarray       # [T, 3]  edge 0→2
    normal: jnp.ndarray   # [T, 3]  unit face normal
    n0: jnp.ndarray       # [T, 3]  vertex normals (face normal when flat)
    n1: jnp.ndarray       # [T, 3]
    n2: jnp.ndarray       # [T, 3]
    mirror: jnp.ndarray   # [T] bool — parallelogram UV rule
    smooth: jnp.ndarray   # [T] bool — interpolate vertex normals
    prim_id: jnp.ndarray  # [T] int32, -1 = padding


class Spheres(PyTreeNode):
    center: jnp.ndarray        # [S, 3] object-space center
    radius: jnp.ndarray        # [S]
    obj_to_world: jnp.ndarray  # [S, 4, 4]
    world_to_obj: jnp.ndarray  # [S, 4, 4]
    normal_mat: jnp.ndarray    # [S, 3, 3]
    transformed: jnp.ndarray   # [S] bool
    prim_id: jnp.ndarray       # [S] int32, -1 = padding


class Planes(PyTreeNode):
    normal: jnp.ndarray       # [P, 3]
    origin_dist: jnp.ndarray  # [P]
    prim_id: jnp.ndarray      # [P] int32, -1 = padding


class CameraRT(PyTreeNode):
    """Render-ready camera: orthonormal basis + projection scalars, the
    output of Camera.InitRender (Camera.cs:54-63, FrustumCamera.cs:24-31,
    OrthoCamera.cs:22-31)."""

    position: jnp.ndarray   # [3]
    look: jnp.ndarray       # [3]
    side: jnp.ndarray       # [3]
    up: jnp.ndarray         # [3]
    w2: jnp.ndarray         # scalar: width / 2
    h2: jnp.ndarray         # scalar: height / 2
    ax: jnp.ndarray         # frustum: tanFOVX2;  ortho: hMult
    ay: jnp.ndarray         # frustum: -tanFOVY2; ortho: -vMult (sign baked)
    image_plane: jnp.ndarray
    dof_amount: jnp.ndarray
    focal_length: jnp.ndarray
    mode: int = field(static=True, default=0)  # 0=frustum 1=ortho


class SceneArrays(PyTreeNode):
    """The frozen scene: everything the render step needs, as one pytree.

    Differentiable leaves: the material table (and geometry, though geometry
    gradients are out of scope).  Static fields keep shapes/trip counts
    compile-time constant.
    """

    triangles: Triangles
    spheres: Spheres
    planes: Planes
    materials: Materials
    background_rgb: jnp.ndarray   # [3]
    background_alpha: jnp.ndarray  # scalar
    ambient_rgb: jnp.ndarray      # [3] (zeros when ambient_is_miss)
    air_refractive_index: jnp.ndarray  # scalar

    width: int = field(static=True, default=0)
    height: int = field(static=True, default=0)
    recursion: int = field(static=True, default=3)
    ambient_is_miss: bool = field(static=True, default=False)
    debug_geom: bool = field(static=True, default=False)
    n_prims: int = field(static=True, default=0)
    # True when ANY triangle interpolates vertex normals (``trinormal``
    # scenes).  Static metadata: the fused megakernel specializes the
    # whole smooth-normal interpolation block away when False (neither
    # shipped scene uses vertex normals), which is exact — with no smooth
    # rows the interpolation is the identity on the face normal.
    any_smooth: bool = field(static=True, default=True)


def _pad_to(n: int, pad: int) -> int:
    if n == 0:
        return pad
    return ((n + pad - 1) // pad) * pad


def freeze_scene(scene: HostScene, dtype=jnp.float32, pad: int = 1
                 ) -> SceneArrays:
    """Convert a HostScene into padded SoA device arrays.

    ``pad`` is the table-size granularity.  The default of 1 keeps tables
    exact-sized (every ray tests every row on every bounce of the dense
    path, so a padding row is wasted work); raise it to
    bucket scenes into fewer compiled shapes when cycling many scenes through
    one process.  Empty tables still get one masked row so shapes stay
    non-degenerate under jit.
    """
    f = lambda x: jnp.asarray(np.asarray(x, dtype=np.float64), dtype=dtype)

    prims = scene.primitives
    n = len(prims)

    # Material table in primitive-id order, with IsReflective gating baked.
    def mat_rows(getter, width=3):
        return np.stack(
            [np.asarray(getter(p.material), dtype=np.float64).reshape(width)
             if width == 3 else getter(p.material) for p in prims]
        ) if n else np.zeros((0, width))

    emission = np.stack([p.material.emission for p in prims]) if n else np.zeros((0, 3))
    diffuse = np.stack([p.material.diffuse for p in prims]) if n else np.zeros((0, 3))
    shininess = np.array([p.material.shininess for p in prims], dtype=np.float64)
    reflective = shininess > 0  # Primitive.cs:111
    specular = np.stack([p.material.specular for p in prims]) if n else np.zeros((0, 3))
    refraction = np.stack([p.material.refraction for p in prims]) if n else np.zeros((0, 3))
    specular = np.where(reflective[:, None], specular, 0.0)
    refraction = np.where(reflective[:, None], refraction, 0.0)

    materials = Materials(
        emission=f(emission),
        diffuse=f(diffuse),
        specular=f(specular),
        refraction=f(refraction),
        refractive_index=f(np.array(
            [p.material.refractive_index for p in prims], dtype=np.float64)),
        shininess=f(shininess),
        two_sided=jnp.asarray(
            np.array([p.material.two_sided for p in prims], dtype=bool)),
        invert=jnp.asarray(
            np.array([p.material.invert for p in prims], dtype=bool)),
    )

    # --- triangles -------------------------------------------------------
    tris = [(i, p) for i, p in enumerate(prims) if isinstance(p, HostTriangle)]
    tn = _pad_to(len(tris), pad)

    def tri_field(fn, shape):
        out = np.zeros((tn,) + shape, dtype=np.float64)
        for j, (_, p) in enumerate(tris):
            out[j] = fn(p)
        return out

    tri_ids = np.full(tn, -1, dtype=np.int32)
    for j, (i, _) in enumerate(tris):
        tri_ids[j] = i
    # Degenerate padding rows get a non-zero normal to avoid NaNs.
    v0 = tri_field(lambda p: p.v0, (3,))
    e1 = tri_field(lambda p: p.edge01, (3,))
    e2 = tri_field(lambda p: p.edge02, (3,))
    nrm = tri_field(lambda p: p.face_normal, (3,))
    nrm[len(tris):] = (0.0, 0.0, 1.0)
    n0 = tri_field(lambda p: p.n0 if p.has_normals else p.face_normal, (3,))
    n1 = tri_field(lambda p: p.n1 if p.has_normals else p.face_normal, (3,))
    n2 = tri_field(lambda p: p.n2 if p.has_normals else p.face_normal, (3,))
    for a in (n0, n1, n2):
        a[len(tris):] = (0.0, 0.0, 1.0)

    mirror = np.zeros(tn, dtype=bool)
    smooth = np.zeros(tn, dtype=bool)
    for j, (_, p) in enumerate(tris):
        mirror[j] = p.mirror
        smooth[j] = p.has_normals

    triangles = Triangles(
        v0=f(v0), e1=f(e1), e2=f(e2), normal=f(nrm),
        n0=f(n0), n1=f(n1), n2=f(n2),
        mirror=jnp.asarray(mirror), smooth=jnp.asarray(smooth),
        prim_id=jnp.asarray(tri_ids),
    )

    # --- spheres ---------------------------------------------------------
    sps = [(i, p) for i, p in enumerate(prims) if isinstance(p, HostSphere)]
    sn = _pad_to(len(sps), pad)
    s_center = np.zeros((sn, 3))
    s_radius = np.full(sn, 1.0)
    s_o2w = np.tile(np.eye(4), (sn, 1, 1))
    s_w2o = np.tile(np.eye(4), (sn, 1, 1))
    s_nm = np.tile(np.eye(3), (sn, 1, 1))
    s_tr = np.zeros(sn, dtype=bool)
    s_ids = np.full(sn, -1, dtype=np.int32)
    for j, (i, p) in enumerate(sps):
        s_center[j] = p.center
        s_radius[j] = p.radius
        s_o2w[j] = p.obj_to_world
        s_w2o[j] = p.world_to_obj
        s_nm[j] = p.normal_matrix[:3, :3]
        s_tr[j] = p.transformed
        s_ids[j] = i

    spheres = Spheres(
        center=f(s_center), radius=f(s_radius),
        obj_to_world=f(s_o2w), world_to_obj=f(s_w2o), normal_mat=f(s_nm),
        transformed=jnp.asarray(s_tr), prim_id=jnp.asarray(s_ids),
    )

    # --- planes ----------------------------------------------------------
    pls = [(i, p) for i, p in enumerate(prims) if isinstance(p, HostPlane)]
    pn = _pad_to(len(pls), pad) if pls else 0
    if pn == 0:
        pn = pad  # keep a (masked) non-empty table for static shapes
    p_norm = np.tile(np.array([0.0, 0.0, 1.0]), (pn, 1))
    p_dist = np.zeros(pn)
    p_ids = np.full(pn, -1, dtype=np.int32)
    for j, (i, p) in enumerate(pls):
        p_norm[j] = p.normal
        p_dist[j] = p.origin_distance
        p_ids[j] = i

    planes = Planes(normal=f(p_norm), origin_dist=f(p_dist),
                    prim_id=jnp.asarray(p_ids))

    ambient_is_miss = scene.ambient_rgb is None
    ambient = np.zeros(3) if ambient_is_miss else scene.ambient_rgb

    return SceneArrays(
        triangles=triangles,
        spheres=spheres,
        planes=planes,
        materials=materials,
        background_rgb=f(scene.background_rgb),
        background_alpha=f(scene.background_alpha),
        ambient_rgb=f(ambient),
        air_refractive_index=f(scene.air_refractive_index),
        width=scene.width,
        height=scene.height,
        recursion=scene.recursion,
        ambient_is_miss=ambient_is_miss,
        debug_geom=scene.debug_geom,
        n_prims=n,
        any_smooth=bool(smooth.any()),
    )


def init_camera(cam: HostCamera, width: int, height: int,
                dtype=jnp.float32) -> CameraRT:
    """Build the render-ready camera basis (Camera.InitRender,
    Camera.cs:54-63) plus per-mode projection scalars."""
    pos = np.asarray(cam.position, dtype=np.float64)
    look_at = np.asarray(cam.look_at, dtype=np.float64)
    up0 = np.asarray(cam.up, dtype=np.float64)

    look = look_at - pos
    look = look / np.linalg.norm(look)
    side = np.cross(look, -up0)
    side = side / np.linalg.norm(side)
    up = np.cross(look, side)
    up = up / np.linalg.norm(up)
    side = -side

    w2 = width / 2.0
    h2 = height / 2.0

    if cam.mode == "frustum":
        tan_y = np.tan(cam.fov_or_size / 2.0)
        ax = tan_y * (width / float(height))
        ay = -tan_y
        mode = 0
    else:  # ortho — OrthoCamera.InitRender (OrthoCamera.cs:22-31)
        cam_w = 1.0 / w2
        cam_h = (1.0 / h2) * (height / float(width))
        ax = cam_w * cam.fov_or_size
        ay = -cam_h * cam.fov_or_size
        mode = 1

    f = lambda x: jnp.asarray(x, dtype=dtype)
    return CameraRT(
        position=f(pos), look=f(look), side=f(side), up=f(up),
        w2=f(w2), h2=f(h2), ax=f(ax), ay=f(ay),
        image_plane=f(cam.image_plane), dof_amount=f(cam.dof_amount),
        focal_length=f(cam.focal_length), mode=mode,
    )
