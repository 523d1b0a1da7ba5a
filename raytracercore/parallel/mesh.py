"""Device mesh construction.

The reference's only parallel axis is CPU threads over image tiles
(FullRaytracer.cs:219-229).  The equivalents here, as mesh axes:

* ``rays``  — data parallelism over pixels/rays (the tile axis).  Uniform
  SPMD batches replace the reference's dynamic tile stealing (SURVEY §5.8).
* ``prims`` — optional model-parallel axis sharding the triangle table;
  each device intersects its slice and the closest hit is reduced with a
  cross-device min (the tensor-parallel analog for a path tracer) —
  implemented by :func:`..parallel.shard.make_prims_sharded_render_pass`.

Default layout puts every device on ``rays``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


def make_mesh(n_rays: Optional[int] = None, n_prims: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (rays, prims) mesh; defaults to all devices on the rays axis."""
    if devices is None:
        devices = jax.devices()
    if n_rays is None:
        n_rays = len(devices) // n_prims
    grid = np.asarray(devices[: n_rays * n_prims]).reshape(n_rays, n_prims)
    return Mesh(grid, (RAYS_AXIS, PRIMS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading axis over ``rays``; trailing axes replicated."""
    return NamedSharding(mesh, P(RAYS_AXIS, *([None] * (ndim - 1))))
