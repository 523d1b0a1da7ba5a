"""Batched camera ray generation.

Mirrors ``Raytracer.GetCameraRay`` (Raytracing/Raytracer.cs:262-282):
uniform sub-pixel jitter, the per-mode ``Camera.GetRay``
(FrustumCamera.cs:33-41 / OrthoCamera.cs:33-38), the image-plane origin
offset (Ray.Offset, Ray.cs:59) and thin-lens depth of field re-aimed at the
focal point.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.types import CameraRT

TWO_PI = 6.283185307179586


def _get_ray(cam: CameraRT, x, y):
    """Camera.GetRay for fractional pixel coordinates [R]."""
    if cam.mode == 0:  # frustum
        off_x = cam.ax * ((x - cam.w2) / cam.w2)
        off_y = cam.ay * ((y - cam.h2) / cam.h2)
        d = (cam.look[None, :] + cam.side[None, :] * off_x[:, None]
             + cam.up[None, :] * off_y[:, None])
        d = vm.normalize(d)
        o = jnp.broadcast_to(cam.position[None, :], d.shape)
    else:  # ortho
        o = (cam.position[None, :]
             + cam.side[None, :] * ((x - cam.w2) * cam.ax)[:, None]
             + cam.up[None, :] * ((y - cam.h2) * cam.ay)[:, None])
        d = jnp.broadcast_to(cam.look[None, :], o.shape)
    return o, d


def camera_rays(cam: CameraRT, px, py, key):
    """Jittered (and optionally defocused) camera rays for pixel indices.

    Args:
      cam: render-ready camera.
      px, py: [R] integer pixel coordinates.
      key: PRNG key; consumes 4 uniforms per ray.

    Returns: (ray_o [R, 3], ray_d [R, 3]).
    """
    dtype = cam.position.dtype
    u = jax.random.uniform(key, (px.shape[0], 4), dtype=dtype)
    sub_x = px.astype(dtype) + u[:, 0]
    sub_y = py.astype(dtype) + u[:, 1]

    o, d = _get_ray(cam, sub_x, sub_y)
    o = o + d * cam.image_plane

    # Depth of field (Raytracer.cs:269-279): sample the lens disc with
    # sqrt-radius, re-trace through the jittered pixel, aim at the focus
    # point of the undisturbed ray.
    focus = o + d * (cam.focal_length - cam.image_plane)
    dist = jnp.sqrt(u[:, 2]) * cam.dof_amount
    angle = u[:, 3] * TWO_PI
    off_x = jnp.cos(angle) * dist
    off_y = jnp.sin(angle) * dist
    o2, d2 = _get_ray(cam, sub_x + off_x, sub_y + off_y)
    o2 = o2 + d2 * cam.image_plane
    d2 = vm.normalize(focus - o2)

    use_dof = cam.dof_amount != 0
    o = jnp.where(use_dof, o2, o)
    d = jnp.where(use_dof, d2, d)
    return o, d


def center_rays(cam: CameraRT, px, py):
    """Deterministic rays through pixel centers — no jitter, no DoF.

    The debug raycaster's ray model (DebugRaycaster.cs casts one plain ray
    per pixel) and the public entry for tools that need reproducible rays.

    Args:
      cam: render-ready camera.
      px, py: [R] integer pixel coordinates.

    Returns: (ray_o [R, 3], ray_d [R, 3]) with the image-plane offset
    applied (Ray.Offset, Ray.cs:59).
    """
    dtype = cam.position.dtype
    o, d = _get_ray(cam, px.astype(dtype) + 0.5, py.astype(dtype) + 0.5)
    return o + d * cam.image_plane, d


def pixel_grid(width: int, height: int):
    """Linear pixel index grids [H*W] in row-major (y, x) order."""
    ys, xs = jnp.meshgrid(jnp.arange(height), jnp.arange(width),
                          indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)

