"""Multi-host (multi-process) support.

The reference never leaves one process (its "backend" is a mutex and a
concurrent queue, FullRaytracer.cs:52-59 — SURVEY §5.8).  The equivalent
here: ``jax.distributed`` across hosts, the scene replicated, rays sharded
over the global mesh, XLA collectives for loss/grad reductions, and an
explicit host gather only for image IO.

Process-spanning meshes come straight from :func:`..parallel.mesh.make_mesh`
(``jax.devices()`` is global after :func:`init_distributed`); this module
adds the init entry point and the film/image gather.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from ..render.film import Film


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize ``jax.distributed`` (multi-host entry point).

    Arguments fall back to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) and, on managed clusters, to JAX's
    own auto-detection (call with no arguments).
    """
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    n = num_processes if num_processes is not None else os.environ.get(
        "JAX_NUM_PROCESSES")
    if n is not None:
        kwargs["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get(
        "JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def gather_film(film: Film) -> Film:
    """Fetch a (possibly process-sharded) film to host-local numpy on every
    process — the IO gather (SURVEY §2.5 strategy 3: accumulate on device,
    gather only for display/output).
    """
    from jax.experimental import multihost_utils

    def fetch(x):
        if x is None:
            return None
        x = jax.numpy.asarray(x)
        if (jax.process_count() > 1
                and not x.is_fully_addressable):  # pragma: no cover - multihost
            return np.asarray(
                multihost_utils.process_allgather(x, tiled=True))
        return np.asarray(x)

    return Film(color_sum=fetch(film.color_sum),
                samples=fetch(film.samples),
                misses=fetch(film.misses),
                color_c=fetch(film.color_c))
