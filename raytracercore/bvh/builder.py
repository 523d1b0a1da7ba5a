"""Host-side BVH builder → flattened SoA arrays for device traversal.

The reference builds its BVH agglomeratively bottom-up with a k-d tree +
min-heap of candidate pairs (Acceleration/BVH.cs:89-191, strategies selected
by size at :193-236).  The rebuild's contract is the *traversal result* — the
closest surviving hit — not the build algorithm (SURVEY §7.4), so we use a
top-down binned-SAH build (numpy, vectorized) which flattens naturally into
the skip-link layout of the stackless device traversal:

* nodes stored in preorder; ``skip[i]`` = node to visit when the ray misses
  node ``i``'s box (or after finishing its leaf) — the "escape" index.
* a hit on an internal node falls through to ``i+1`` (its left child).
* leaves own up to ``leaf_size`` primitive slots in a dense [L, K] index
  matrix (padded with -1), so the device-side leaf test is a fixed-shape
  gather — no variable-length loops on the device.

The same skip-volume idea the reference uses (``MakeParent`` marking
redundant child AABBs, BVH.cs:44-48) is subsumed by the skip-link scheme.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..config import BVH_LEAF_SIZE
from ..core.pytree import PyTreeNode


class BVHArrays(PyTreeNode):
    """Flattened skip-link BVH over the triangle table."""

    bmin: jnp.ndarray       # [N, 3]
    bmax: jnp.ndarray       # [N, 3]
    skip: jnp.ndarray       # [N] int32 escape index; N ⇒ done
    leaf_slot: jnp.ndarray  # [N] int32 row into leaf_prims, -1 for internal
    leaf_prims: jnp.ndarray  # [L, K] int32 triangle-table indices, -1 pad

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]


@dataclasses.dataclass
class _Node:
    bmin: np.ndarray
    bmax: np.ndarray
    left: "_Node | None" = None
    right: "_Node | None" = None
    prims: np.ndarray | None = None  # triangle indices for leaves


def triangle_bounds(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    mirror: np.ndarray):
    """Per-triangle AABBs; mirrored quads include the 4th corner
    (v0+e1+e2 — Triangle.GetMaxCenterDistance, Triangle.cs:237-241)."""
    v1 = v0 + e1
    v2 = v0 + e2
    v3 = v0 + e1 + e2
    corners = np.stack([v0, v1, v2, v3], axis=1)  # [T, 4, 3]
    # Non-mirrored triangles ignore the 4th corner.
    big = np.where(mirror[:, None, None], corners,
                   np.concatenate([corners[:, :3],
                                   corners[:, :1]], axis=1))
    return big.min(axis=1), big.max(axis=1)


def _build(idx, bmin, bmax, centers, leaf_size, n_bins=16):
    """Recursive binned-SAH split returning a _Node tree."""
    node_bmin = bmin[idx].min(axis=0)
    node_bmax = bmax[idx].max(axis=0)
    n = len(idx)
    if n <= leaf_size:
        return _Node(node_bmin, node_bmax, prims=idx)

    c = centers[idx]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))
    if extent[axis] <= 0:
        # All centers identical: split arbitrarily in half.
        half = n // 2
        return _Node(node_bmin, node_bmax,
                     left=_build(idx[:half], bmin, bmax, centers, leaf_size),
                     right=_build(idx[half:], bmin, bmax, centers, leaf_size))

    # Binned SAH along the widest axis.
    rel = (c[:, axis] - cmin[axis]) / extent[axis]
    bins = np.minimum((rel * n_bins).astype(np.int32), n_bins - 1)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    best_cost, best_split = np.inf, None
    for split in range(1, n_bins):
        lmask = bins < split
        nl = int(lmask.sum())
        nr = n - nl
        if nl == 0 or nr == 0:
            continue
        l_lo = bmin[idx[lmask]].min(axis=0)
        l_hi = bmax[idx[lmask]].max(axis=0)
        r_lo = bmin[idx[~lmask]].min(axis=0)
        r_hi = bmax[idx[~lmask]].max(axis=0)
        cost = area(l_lo, l_hi) * nl + area(r_lo, r_hi) * nr
        if cost < best_cost:
            best_cost, best_split = cost, split

    if best_split is None:
        half = n // 2
        order = np.argsort(c[:, axis], kind="stable")
        l_idx, r_idx = idx[order[:half]], idx[order[half:]]
    else:
        lmask = bins < best_split
        l_idx, r_idx = idx[lmask], idx[~lmask]

    return _Node(node_bmin, node_bmax,
                 left=_build(l_idx, bmin, bmax, centers, leaf_size),
                 right=_build(r_idx, bmin, bmax, centers, leaf_size))


def build_boxes_bvh(bmin: np.ndarray, bmax: np.ndarray, valid: np.ndarray,
                    leaf_size: int = BVH_LEAF_SIZE, dtype=jnp.float32,
                    backend: str = "auto") -> BVHArrays:
    """Build a skip-link BVH over arbitrary per-row AABBs (the reference
    bounds every primitive type through IBoundedObject, Scene.cs:39-49);
    ``leaf_prims`` index the rows of the given box arrays.

    ``backend``: "numpy" (the reference implementation below), "native"
    (the C++ builder in ../native — same layout, built for million-triangle
    scenes), or "auto" (native when available and worthwhile).
    """
    row_idx = np.nonzero(valid)[0]
    if len(row_idx) == 0:
        return BVHArrays(
            bmin=jnp.zeros((1, 3), dtype), bmax=jnp.zeros((1, 3), dtype),
            skip=jnp.array([1], jnp.int32),
            leaf_slot=jnp.array([-1], jnp.int32),
            leaf_prims=jnp.full((1, leaf_size), -1, jnp.int32))

    if backend != "numpy":
        from ..native import build_bvh_native

        use_native = backend == "native" or len(row_idx) >= 4096
        if use_native:
            out = build_bvh_native(
                np.asarray(bmin[row_idx], np.float32),
                np.asarray(bmax[row_idx], np.float32), leaf_size)
            if out is not None:
                nb_min, nb_max, skip, slot, prims = out
                # Leaf entries index the valid subset — map back to table
                # rows.
                mapped = np.where(prims >= 0,
                                  row_idx[np.maximum(prims, 0)], -1)
                return BVHArrays(
                    bmin=jnp.asarray(nb_min, dtype),
                    bmax=jnp.asarray(nb_max, dtype),
                    skip=jnp.asarray(skip, jnp.int32),
                    leaf_slot=jnp.asarray(slot, jnp.int32),
                    leaf_prims=jnp.asarray(mapped.astype(np.int32)))
            if backend == "native":
                raise RuntimeError("native BVH builder unavailable")

    centers = (bmin + bmax) / 2.0
    root = _build(row_idx, bmin, bmax, centers, leaf_size)

    # Preorder flatten with escape links.
    nodes_bmin, nodes_bmax, skips, leaf_slots = [], [], [], []
    leaf_rows = []

    def emit(node: _Node) -> None:
        """Append node; fix its skip afterwards (escape = index after the
        whole subtree)."""
        i = len(nodes_bmin)
        nodes_bmin.append(node.bmin)
        nodes_bmax.append(node.bmax)
        skips.append(-1)       # patched below
        if node.prims is not None:
            leaf_slots.append(len(leaf_rows))
            row = np.full(leaf_size, -1, np.int64)
            row[: len(node.prims)] = node.prims
            leaf_rows.append(row)
        else:
            leaf_slots.append(-1)
            emit(node.left)
            emit(node.right)
        skips[i] = len(nodes_bmin)  # escape = first index past the subtree

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * len(row_idx)))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old_limit)

    return BVHArrays(
        bmin=jnp.asarray(np.stack(nodes_bmin), dtype),
        bmax=jnp.asarray(np.stack(nodes_bmax), dtype),
        skip=jnp.asarray(np.array(skips), jnp.int32),
        leaf_slot=jnp.asarray(np.array(leaf_slots), jnp.int32),
        leaf_prims=jnp.asarray(np.stack(leaf_rows), jnp.int32),
    )


def build_triangle_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       mirror: np.ndarray, valid: np.ndarray,
                       leaf_size: int = BVH_LEAF_SIZE, dtype=jnp.float32,
                       backend: str = "auto") -> BVHArrays:
    """Build a skip-link BVH over the valid rows of a triangle table."""
    bmin, bmax = triangle_bounds(v0, e1, e2, mirror)
    return build_boxes_bvh(bmin, bmax, valid, leaf_size, dtype, backend)


def build_bvh(host_scene, leaf_size=BVH_LEAF_SIZE,
              dtype=jnp.float32) -> BVHArrays:
    """Build the triangle BVH for a HostScene (sphere/plane tables stay
    brute-force — they are tiny in every reference scene; a unified BVH over
    all primitive types is the LBVH milestone)."""
    tris = host_scene.triangles
    if not tris:
        return build_triangle_bvh(np.zeros((0, 3)), np.zeros((0, 3)),
                                  np.zeros((0, 3)), np.zeros(0, bool),
                                  np.zeros(0, bool), leaf_size, dtype)
    v0 = np.stack([t.v0 for t in tris])
    e1 = np.stack([t.edge01 for t in tris])
    e2 = np.stack([t.edge02 for t in tris])
    mirror = np.array([t.mirror for t in tris], bool)
    valid = np.ones(len(tris), bool)
    return build_triangle_bvh(v0, e1, e2, mirror, valid, leaf_size, dtype)
