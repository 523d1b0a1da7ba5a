"""Progressive renderer — the orchestration layer.

Replaces ``FullRaytracer`` (Raytracing/FullRaytracer.cs): where the reference
spawns one OS thread per core and deals tiles round-robin through a mutex
(FullRaytracer.cs:219-229, 297-302), this build runs one jitted full-frame
render pass per sample — the whole image is the "tile", the device's
threads are the "threads".  Progressive refinement = calling
``step`` repeatedly; every pass adds +1 sample/pixel exactly like the
reference's wraparound tile loop (Raytracer.cs:302-327).

Status/throughput reporting mirrors the reference's samples/px/sec metric
(FullRaytracer.cs:346-357); checkpointing saves the film + sample counter
(impossible in the reference, whose accumulators are RAM-only — SURVEY §5.4).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..intersect.dispatch import closest_hit
from ..scene.types import (HostScene, SceneArrays, freeze_scene, init_camera)
from . import camera as cam_mod
from .film import Film
from .integrator import trace


@functools.partial(jax.jit, static_argnames=("closest_fn", "trace_fn"))
def render_pass(scene: SceneArrays, camera, film: Film, key,
                closest_fn=closest_hit, trace_fn=None) -> Film:
    """One full-frame progressive pass: +1 sample for every pixel.

    ``trace_fn`` overrides the whole integrator call — signature
    (scene, ray_o, ray_d, key) → (color, miss) — which is how the Triton
    megakernel (:func:`.fused.trace_fused`) plugs in on the GPU.
    """
    h, w = film.shape
    px, py = cam_mod.pixel_grid(w, h)
    k_cam, k_path = jax.random.split(key)
    ray_o, ray_d = cam_mod.camera_rays(camera, px, py, k_cam)
    if trace_fn is not None:
        color, miss = trace_fn(scene, ray_o, ray_d, k_path)
    else:
        # Static bounce count (fori_loop): at full-frame batches some ray
        # always survives to the recursion cap, so the whole-wavefront
        # early-exit while_loop saves nothing at steady state and compiles
        # more slowly.
        color, miss = trace(scene, ray_o, ray_d, k_path,
                            closest_fn=closest_fn, early_exit=False)
    return film.add_full_frame(color, miss)


@functools.partial(jax.jit, static_argnames=("closest_fn", "n", "trace_fn"))
def render_passes(scene: SceneArrays, camera, film: Film, base_key, start,
                  n: int = 1, closest_fn=closest_hit,
                  trace_fn=None) -> Film:
    """``n`` progressive passes fused into ONE compiled call.

    A ``fori_loop`` over passes pays host dispatch once.  Pass ``i`` uses
    ``fold_in(base_key, start + i)`` — the same key schedule as issuing
    single passes with ``fold_in(base_key, pass_index)``, so results are
    invariant to how a run is chunked into calls.
    """
    h, w = film.shape
    px, py = cam_mod.pixel_grid(w, h)

    def body(i, f):
        key = jax.random.fold_in(base_key, start + i)
        k_cam, k_path = jax.random.split(key)
        with jax.named_scope("camera_rays"):
            ray_o, ray_d = cam_mod.camera_rays(camera, px, py, k_cam)
        if trace_fn is not None:
            with jax.named_scope("trace_fused"):
                color, miss = trace_fn(scene, ray_o, ray_d, k_path)
        else:
            # early_exit=False: see render_pass.
            color, miss = trace(scene, ray_o, ray_d, k_path,
                                closest_fn=closest_fn, early_exit=False)
        with jax.named_scope("film_accum"):
            return f.add_full_frame(color, miss)

    return jax.lax.fori_loop(0, n, body, film)


class Renderer:
    """Progressive scene renderer with pause/resume/checkpoint.

    Equivalent surface to FullRaytracer: Start (construct), step/run
    (render loop), status throughput, GetBitmap (image()), camera switching
    (Scene.NextCamera, Scene.cs:122-135).
    """

    def __init__(self, scene: HostScene, camera_index: int = 0,
                 dtype=jnp.float32, seed: int = 0,
                 accelerator: str = "auto", closest_fn=None,
                 compensated: bool = False):
        """``accelerator``: "brute" (dense scan), "bvh", or "auto" — BVH
        once the triangle table outgrows the dense scan's sweet spot
        (mirrors Scene.Prepare building the BVH lazily, Scene.cs:39-49).

        ``compensated``: Neumaier-compensated film accumulation for
        reference-scale spp runs (thousands of samples/px) where plain f32
        sums lose low-order sample contributions."""
        self.host_scene = scene
        self.dtype = dtype
        self.compensated = compensated
        self.arrays = freeze_scene(scene, dtype=dtype)
        self.camera_index = camera_index
        self.trace_fn = None
        if closest_fn is not None:
            self.closest_fn = closest_fn
        else:
            from ..config import BVH_AUTO_THRESHOLD
            n_tris = len(scene.triangles)
            use_bvh = accelerator == "bvh" or (
                accelerator == "auto" and n_tris > BVH_AUTO_THRESHOLD)
            if use_bvh:
                from ..bvh import build_bvh
                from ..intersect.dispatch import make_bvh_closest_fn
                self.bvh = build_bvh(scene, dtype=dtype)
                self.closest_fn = make_bvh_closest_fn(self.bvh)
            else:
                # Forward rendering needs no gradients: on the GPU the whole
                # bounce loop runs in the megakernel.
                from ..config import trace_route
                from . import fused
                self.closest_fn = closest_hit
                if trace_route(self.arrays, dtype) == "triton":
                    self.trace_fn = fused.trace_fused
        self._base_key = jax.random.PRNGKey(seed)
        self.reset()

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        s = self.host_scene
        self.camera = init_camera(s.cameras[self.camera_index], s.width,
                                  s.height, dtype=self.dtype)
        self.film = Film.create(s.height, s.width, self.dtype,
                                compensated=self.compensated)
        self.pass_index = 0
        self._elapsed = 0.0

    def next_camera(self) -> bool:
        """Cycle cameras; returns True on wraparound (Scene.cs:127-135).
        Resets accumulation like the reference's render restart."""
        self.camera_index += 1
        wrapped = self.camera_index >= len(self.host_scene.cameras)
        if wrapped:
            self.camera_index = 0
        self.reset()
        return wrapped

    # -- rendering ---------------------------------------------------------

    def step(self, n: int = 1) -> None:
        """Run n progressive passes (+n samples/pixel) in one device call."""
        t0 = time.perf_counter()
        self.film = render_passes(self.arrays, self.camera, self.film,
                                  self._base_key, jnp.int32(self.pass_index),
                                  n=n, closest_fn=self.closest_fn,
                                  trace_fn=self.trace_fn)
        self.pass_index += n
        jax.block_until_ready(self.film)
        self._elapsed += time.perf_counter() - t0

    def run(self, spp: int, status_cb: Optional[Callable] = None,
            status_every: int = 8) -> None:
        """Render to a target samples/pixel with optional status callbacks
        (the coordinator loop, FullRaytracer.cs:307-370)."""
        while self.pass_index < spp:
            n = min(status_every, spp - self.pass_index)
            self.step(n)
            if status_cb is not None:
                status_cb(self.status())

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        """Throughput metrics in the reference's terms
        (FullRaytracer.cs:346-357): samples/px/sec plus the asymptotic
        progress model spp/(spp+1000)."""
        spp = self.pass_index
        sps = spp / self._elapsed if self._elapsed > 0 else 0.0
        h, w = self.film.shape
        return {
            "samples_per_px": spp,
            "samples_per_px_per_sec": sps,
            "paths_per_sec": sps * h * w,
            "elapsed_sec": self._elapsed,
            "progress": spp / (spp + 1000.0),
        }

    def profile(self, logdir: str, n: int = 4) -> None:
        """Capture a profiler trace of ``n`` render passes (SURVEY §5.1).
        Phases appear as the named scopes
        camera_rays / closest_hit / trace_fused / film_accum."""
        with jax.profiler.trace(logdir):
            self.step(n)

    def image(self, exposure: float = 1.0) -> np.ndarray:
        """Tonemapped uint8 RGBA frame (GetBitmap, FullRaytracer.cs:179-205)."""
        s = self.host_scene
        out = self.film.to_uint8(
            jnp.asarray(s.background_rgb, self.dtype),
            jnp.asarray(s.background_alpha, self.dtype), exposure)
        return np.asarray(out)

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        extra = {}
        if self.film.color_c is not None:
            extra["color_c"] = np.asarray(self.film.color_c)
        np.savez(path,
                 color_sum=np.asarray(self.film.color_sum),
                 samples=np.asarray(self.film.samples),
                 misses=np.asarray(self.film.misses),
                 pass_index=self.pass_index,
                 camera_index=self.camera_index, **extra)

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        self.camera_index = int(data["camera_index"])
        s = self.host_scene
        self.camera = init_camera(s.cameras[self.camera_index], s.width,
                                  s.height, dtype=self.dtype)
        cc = jnp.asarray(data["color_c"]) if "color_c" in data else None
        self.film = Film(color_sum=jnp.asarray(data["color_sum"]),
                         samples=jnp.asarray(data["samples"]),
                         misses=jnp.asarray(data["misses"]), color_c=cc)
        self.compensated = cc is not None
        self.pass_index = int(data["pass_index"])
