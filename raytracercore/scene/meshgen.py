"""Procedural mesh-scene generation for at-scale benchmarks.

BASELINE config 5 calls for a ~1M-triangle replicated mesh at 1024x1024;
the reference's scale bar is its >200k-primitive builder tier
(Acceleration/BVH.cs:193-199).  The reference has no mesh format (scenes are
hand-written primitives), so scale testing uses procedural geometry:
a grid of replicated icospheres over a floor, lit by an emissive quad —
every triangle row built directly as SoA arrays (no per-primitive host
objects; a million Python objects would dominate load time).
"""

from __future__ import annotations

import numpy as np

from .types import (HostCamera, Materials, Planes, SceneArrays, Spheres,
                    Triangles)

import jax.numpy as jnp


def icosphere(subdiv: int):
    """Unit icosphere: returns (verts [V,3] f64, faces [F,3] int32).

    20 * 4^subdiv faces (subdiv 4 → 5120).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                m = m / np.linalg.norm(m)
                edge_mid[k] = len(vlist)
                vlist.append(m)
            return edge_mid[k]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces.astype(np.int32)


def make_mesh_scene(grid: int = 14, subdiv: int = 4, seed: int = 0,
                    recursion: int = 4, width: int = 1024,
                    height: int = 1024, smooth: bool = True,
                    dtype=jnp.float32):
    """A grid x grid field of replicated icospheres + floor + quad light.

    grid=14, subdiv=4 → 14*14*5120 + 2 = 1,003,522 triangles.

    Returns (SceneArrays, HostCamera, host_tri_bounds_inputs) where the
    last element is the (v0, e1, e2, mirror, valid) numpy tuple the BVH
    builder consumes — kept on host so callers can build the BVH without
    pulling the device arrays back.
    """
    rng = np.random.default_rng(seed)
    sv, sf = icosphere(subdiv)

    spacing = 2.6
    half = (grid - 1) * spacing / 2.0

    v0_list, v1_list, v2_list = [], [], []
    n0_list, n1_list, n2_list = [], [], []
    diffuse_rows = []

    for gy in range(grid):
        for gx in range(grid):
            scale = 0.8 + 0.4 * rng.random()
            cx = gx * spacing - half
            cy = gy * spacing - half
            cz = scale  # resting on the floor z=0
            v = sv * scale + np.array([cx, cy, cz])
            tri_v = v[sf]  # [F, 3, 3]
            v0_list.append(tri_v[:, 0])
            v1_list.append(tri_v[:, 1])
            v2_list.append(tri_v[:, 2])
            if smooth:
                n = sv[sf]  # unit sphere verts ARE the normals
                n0_list.append(n[:, 0])
                n1_list.append(n[:, 1])
                n2_list.append(n[:, 2])
            diffuse_rows.append(
                np.tile(0.25 + 0.7 * rng.random(3), (len(sf), 1)))

    # Floor: one mirrored quad (two corners + edges span the field), plus an
    # emissive quad light overhead.
    ext = half + 3.0
    floor_v0 = np.array([[-ext, -ext, 0.0]])
    floor_e1 = np.array([[2 * ext, 0.0, 0.0]])
    floor_e2 = np.array([[0.0, 2 * ext, 0.0]])
    light_v0 = np.array([[-ext / 2, -ext / 2, 6.0 + half]])
    light_e1 = np.array([[ext, 0.0, 0.0]])
    light_e2 = np.array([[0.0, ext, 0.0]])

    v0 = np.concatenate(v0_list + [floor_v0, light_v0])
    v1 = np.concatenate(v1_list + [floor_v0 + floor_e1, light_v0 + light_e1])
    v2 = np.concatenate(v2_list + [floor_v0 + floor_e2, light_v0 + light_e2])
    e1 = v1 - v0
    e2 = v2 - v0
    normal = np.cross(e1, e2)
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True),
                         1e-30)
    T = len(v0)
    mirror = np.zeros(T, bool)
    mirror[-2:] = True  # floor + light are quads
    smooth_f = np.zeros(T, bool)
    if smooth:
        smooth_f[:-2] = True
        n0 = np.concatenate(n0_list + [normal[-2:][:1], normal[-1:]])
        n1 = np.concatenate(n1_list + [normal[-2:][:1], normal[-1:]])
        n2 = np.concatenate(n2_list + [normal[-2:][:1], normal[-1:]])
    else:
        n0 = n1 = n2 = normal

    prim_id = np.arange(T, dtype=np.int32)

    diffuse = np.concatenate(
        diffuse_rows + [np.array([[0.6, 0.6, 0.65]]),
                        np.array([[0.0, 0.0, 0.0]])])
    emission = np.zeros((T, 3))
    emission[-1] = [14.0, 13.0, 12.0]

    j = lambda a: jnp.asarray(a, dtype)
    tris = Triangles(v0=j(v0), e1=j(e1), e2=j(e2), normal=j(normal),
                     n0=j(n0), n1=j(n1), n2=j(n2),
                     mirror=jnp.asarray(mirror),
                     smooth=jnp.asarray(smooth_f),
                     prim_id=jnp.asarray(prim_id))
    # Empty (1-row padded) sphere/plane tables.
    spheres = Spheres(center=j(np.zeros((1, 3))), radius=j(np.ones(1)),
                      obj_to_world=j(np.eye(4)[None]),
                      world_to_obj=j(np.eye(4)[None]),
                      normal_mat=j(np.eye(3)[None]),
                      transformed=jnp.zeros(1, bool),
                      prim_id=jnp.full((1,), -1, jnp.int32))
    planes = Planes(normal=j(np.array([[0.0, 0.0, 1.0]])),
                    origin_dist=j(np.zeros(1)),
                    prim_id=jnp.full((1,), -1, jnp.int32))
    mats = Materials(
        emission=j(emission), diffuse=j(diffuse),
        specular=j(np.zeros((T, 3))), refraction=j(np.zeros((T, 3))),
        refractive_index=j(np.ones(T)), shininess=j(np.full(T, 100.0)),
        two_sided=jnp.zeros(T, bool), invert=jnp.zeros(T, bool))

    arrays = SceneArrays(
        triangles=tris, spheres=spheres, planes=planes, materials=mats,
        background_rgb=j(np.zeros(3)), background_alpha=j(0.0),
        ambient_rgb=j(np.full(3, 0.12)),
        air_refractive_index=j(1.000293),
        width=width, height=height, recursion=recursion,
        ambient_is_miss=False, debug_geom=False, n_prims=T)

    cam = HostCamera(
        mode="frustum",
        position=np.array([0.0, -half - 14.0, half * 0.9 + 7.0]),
        look_at=np.array([0.0, 0.0, 1.0]),
        up=np.array([0.0, 0.0, 1.0]),
        fov_or_size=np.deg2rad(55.0))
    host_tris = (v0.astype(np.float32), e1.astype(np.float32),
                 e2.astype(np.float32), mirror, np.ones(T, bool))
    return arrays, cam, host_tris
