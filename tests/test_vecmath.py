"""Math-layer tests: formulas vs the reference's scalar definitions."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracercore.core import color, vecmath as vm


def rodrigues_matrix(angle, axis):
    """Reference MatrixTransforms.Rotate (MatrixTransforms.cs:25-37)."""
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    oc = 1 - c
    return np.array([
        [c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s],
        [y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s],
        [z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc],
    ])


def test_create_horizontal_matches_reference():
    v = jnp.array([[0.3, -0.4, 0.86], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    h = np.asarray(vm.create_horizontal(v))
    # Perpendicular to input and to z-cross definition
    np.testing.assert_allclose((h * np.asarray(v)).sum(-1)[:1], 0, atol=1e-6)
    # Degenerate (v ∥ z) rows → (1,0,0)  (Vec4D.cs:37-41)
    np.testing.assert_allclose(h[1], [1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(h[2], [1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(h, axis=-1), 1, atol=1e-6)


def test_create_horizon_matches_matrix_form():
    rng = np.random.default_rng(0)
    pole = rng.normal(size=(16, 3))
    pole /= np.linalg.norm(pole, axis=-1, keepdims=True)
    z = rng.uniform(-1, 1, size=16)
    theta = rng.uniform(0, 2 * np.pi, size=16)

    got = np.asarray(vm.create_horizon(
        jnp.asarray(pole), jnp.asarray(z), jnp.asarray(theta)))

    for i in range(16):
        p = pole[i]
        cross = np.cross(p, [0, 0, 1.0])
        if np.linalg.norm(cross) == 0:
            cross = np.array([1.0, 0, 0])
        else:
            cross /= np.linalg.norm(cross)
        base = p * z[i] + cross * np.sqrt(1 - z[i] ** 2)
        expected = rodrigues_matrix(theta[i], p) @ base
        np.testing.assert_allclose(got[i], expected, atol=1e-5)
    # All results unit length
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-5)


def test_reflect():
    n = jnp.array([[0.0, 0.0, 1.0]])
    d = jnp.array([[1.0, 0.0, -1.0]]) / np.sqrt(2)
    cos = -vm.dot(n, d)
    r = np.asarray(vm.reflect(n, d, cos))
    np.testing.assert_allclose(r, [[1 / np.sqrt(2), 0, 1 / np.sqrt(2)]],
                               atol=1e-6)


def test_luminance_rec601():
    c = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                   [1.0, 1.0, 1.0]])
    lum = np.asarray(color.luminance(c))
    np.testing.assert_allclose(lum, [0.299, 0.587, 0.114, 1.0], atol=1e-7)


def test_tonemap_matches_sampleset():
    # One pixel, 3 hit samples summing to (1.5, .9, .3), 1 miss,
    # background (0.2, 0.2, 0.2) alpha 0.5, exposure 2.
    color_sum = jnp.array([[[1.5, 0.9, 0.3]]])
    samples = jnp.array([[3]])
    misses = jnp.array([[1]])
    back = jnp.array([0.2, 0.2, 0.2])
    rgb, alpha = color.tonemap(color_sum, samples, misses, back, 0.5,
                               exposure=2.0)

    # Reference formula (SampleSet.cs:88-107):
    mult = 2.0 / 3
    r = np.array([1.5, 0.9, 0.3]) * mult
    back_alpha_amt = 1 / 4
    back_amt = back_alpha_amt * 0.5
    r = r + (0.2 - r) * back_amt
    a = 1 + (0.5 - 1) * back_alpha_amt
    r = np.clip(r, 0, 1) ** (1 / 2.2)
    np.testing.assert_allclose(np.asarray(rgb)[0, 0], r, atol=1e-5)
    assert float(alpha[0, 0]) == pytest.approx(a, abs=1e-6)


def test_tonemap_no_samples_shows_background():
    rgb, alpha = color.tonemap(
        jnp.zeros((1, 1, 3)), jnp.zeros((1, 1)), jnp.zeros((1, 1)),
        jnp.array([0.25, 0.5, 0.75]), 0.125, exposure=1.0)
    np.testing.assert_allclose(
        np.asarray(rgb)[0, 0], np.array([0.25, 0.5, 0.75]) ** (1 / 2.2),
        atol=1e-5)
    assert float(alpha[0, 0]) == pytest.approx(0.125)


def test_transform_point_dir():
    m = np.eye(4)
    m[:3, 3] = [1, 2, 3]
    p = vm.transform_point(m, np.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(p, [2, 2, 3])
    d = vm.transform_dir(m, np.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(d, [1, 0, 0])
