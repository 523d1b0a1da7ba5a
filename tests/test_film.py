"""Film accumulation: compensated summation at reference-scale spp.

The reference accumulates in f64 (DoubleColor sums, SampleSet.cs:10-44) and
runs to thousands of spp; plain f32 sums lose low-order contributions once
the running sum is large.  Film(compensated=True) must track the f64 result.
"""

import jax
import jax.numpy as jnp
import numpy as np

from raytracercore.render.film import Film

BIG = float(2 ** 24)   # ulp(BIG) = 2 in f32: +0.5 increments vanish
SMALL = 0.5
N = 1000


def _accumulate(compensated):
    film = Film.create(1, 1, compensated=compensated)
    no_miss = jnp.zeros((1,), bool)
    film = film.add_full_frame(jnp.full((1, 3), BIG, jnp.float32), no_miss)

    def body(_, f):
        return f.add_full_frame(jnp.full((1, 3), SMALL, jnp.float32),
                                no_miss)

    return jax.jit(lambda f: jax.lax.fori_loop(0, N, body, f))(film)


def test_compensated_tracks_f64():
    exact = BIG + N * SMALL  # representable exactly in f64
    plain = _accumulate(compensated=False)
    comp = _accumulate(compensated=True)
    # Plain f32 silently drops every increment (this is the failure mode).
    assert float(plain.color_sum[0, 0, 0]) == BIG
    # Compensated recovers the true sum to f32 rounding of the total.
    got = float(comp.corrected_sum[0, 0, 0])
    np.testing.assert_allclose(got, exact, rtol=1e-7)
    assert float(comp.samples[0, 0]) == N + 1


def test_compensated_merge():
    a = _accumulate(compensated=True)
    merged = a.merge(a)
    got = float(merged.corrected_sum[0, 0, 0])
    np.testing.assert_allclose(got, 2 * (BIG + N * SMALL), rtol=1e-7)
    assert float(merged.samples[0, 0]) == 2 * (N + 1)
