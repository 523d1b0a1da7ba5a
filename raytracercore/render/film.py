"""Progressive accumulation film.

The device-resident replacement for the reference's ``SampleSet[,]`` grid
(Raytracing/SampleSet.cs, FullRaytracer.cs:259-266): per-pixel color sum,
hit-sample count and miss count, living on device as a pytree — trivially
checkpointable and shard-able, unlike the reference's RAM-only state
(SURVEY §5.4).

The reference accumulates in f64 (DoubleColor) and runs to thousands of spp
(4,826 in Screenshots/app.png).  In f32 a +1-sample increment at that
magnitude loses ~3 decimal digits, so :meth:`Film.create` offers
``compensated=True``: Neumaier compensated summation for ``color_sum`` — f32
storage (no x64 emulation) with f64-like accumulation error.
``samples``/``misses`` are integer-valued counts, exact in f32 to 2^24.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from ..core.pytree import PyTreeNode

from ..core.color import to_uint8, tonemap


def _neumaier_add(s, c, x):
    """One Neumaier compensated-sum step: returns (s', c') with the true sum
    ≈ s' + c'.  Unlike classic Kahan this stays accurate when the increment
    exceeds the running sum."""
    t = s + x
    lost = jnp.where(jnp.abs(s) >= jnp.abs(x), (s - t) + x, (x - t) + s)
    return t, c + lost


class Film(PyTreeNode):
    color_sum: jnp.ndarray  # [H, W, 3]
    samples: jnp.ndarray    # [H, W] float (counts)
    misses: jnp.ndarray     # [H, W]
    # Neumaier compensation for color_sum; None ⇒ plain summation.
    color_c: Optional[jnp.ndarray] = None

    @classmethod
    def create(cls, height: int, width: int, dtype=jnp.float32,
               compensated: bool = False):
        return cls(color_sum=jnp.zeros((height, width, 3), dtype),
                   samples=jnp.zeros((height, width), dtype),
                   misses=jnp.zeros((height, width), dtype),
                   color_c=(jnp.zeros((height, width, 3), dtype)
                            if compensated else None))

    @property
    def shape(self):
        return self.samples.shape

    def add_full_frame(self, color, miss):
        """Accumulate one sample for every pixel (row-major flat [H*W, 3]).

        A miss sample contributes to ``misses`` only (the Placeholder path,
        FullRaytracer.cs:334-337); hits add color + sample count.
        """
        h, w = self.shape
        color = color.reshape(h, w, 3)
        miss = miss.reshape(h, w)
        hit = ~miss
        contrib = jnp.where(hit[..., None], color, 0.0)
        if self.color_c is None:
            cs, cc = self.color_sum + contrib, None
        else:
            cs, cc = _neumaier_add(self.color_sum, self.color_c, contrib)
        return Film(
            color_sum=cs,
            samples=self.samples + hit.astype(self.samples.dtype),
            misses=self.misses + miss.astype(self.misses.dtype),
            color_c=cc,
        )

    def add_scatter(self, pix_linear, color, miss):
        """Accumulate samples at arbitrary pixel indices (tile/shard path).

        Scattered adds can collide on repeated indices, so compensation is
        not maintained here — the error term is simply carried unchanged.
        """
        h, w = self.shape
        hit = ~miss
        cs = self.color_sum.reshape(h * w, 3).at[pix_linear].add(
            jnp.where(hit[:, None], color, 0.0))
        sm = self.samples.reshape(h * w).at[pix_linear].add(
            hit.astype(self.samples.dtype))
        ms = self.misses.reshape(h * w).at[pix_linear].add(
            miss.astype(self.misses.dtype))
        return Film(color_sum=cs.reshape(h, w, 3),
                    samples=sm.reshape(h, w), misses=ms.reshape(h, w),
                    color_c=self.color_c)

    def merge(self, other: "Film") -> "Film":
        """Combine two accumulators (cross-device reduction)."""
        cc = self.color_c
        if cc is not None or other.color_c is not None:
            z = jnp.zeros_like(self.color_sum)
            cc = ((self.color_c if self.color_c is not None else z)
                  + (other.color_c if other.color_c is not None else z))
        return Film(color_sum=self.color_sum + other.color_sum,
                    samples=self.samples + other.samples,
                    misses=self.misses + other.misses,
                    color_c=cc)

    @property
    def corrected_sum(self):
        """color_sum with the compensation folded in."""
        if self.color_c is None:
            return self.color_sum
        return self.color_sum + self.color_c

    def to_image(self, background_rgb, background_alpha, exposure=1.0):
        """Tonemapped [0,1] image + alpha (SampleSet.GetOutput semantics)."""
        return tonemap(self.corrected_sum, self.samples, self.misses,
                       background_rgb, background_alpha, exposure)

    def to_uint8(self, background_rgb, background_alpha, exposure=1.0):
        rgb, alpha = self.to_image(background_rgb, background_alpha, exposure)
        return to_uint8(rgb, alpha)
