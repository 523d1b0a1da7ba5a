"""Whole-path megakernel (render/fused.py) vs the XLA-side integrator.

Both consume the :func:`prepare_uniforms` channel contract with the same key
schedule, so at matched RNG they trace the same stochastic paths; residual
differences are f32 associativity, which can occasionally flip a discrete
branch pick on a knife-edge ray.  The tests demand agreement for the
overwhelming majority of rays and close means overall.

The kernel runs here in the Pallas interpreter (``interpret=True``); its
compiled form is compared on the card by ``chip_smoke.py``.  Small synthetic
scenes keep interpret-mode cost down: an emissive quad light, a two-sided
plane, a glass sphere (Fresnel/TIR path) and a mirror sphere cover every
branch of the bounce loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracercore.render import camera as cam_mod
from raytracercore.render.fused import trace_fused
from raytracercore.render.integrator import PathTape, prepare_uniforms, trace
from raytracercore.scene import loader
from raytracercore.scene.types import freeze_scene, init_camera

SCENE = """
size 16 16
recursion 4
ambient color 0.05 0.05 0.05
camera 0 1 4  0 1 0  0 1 0  60
emission 6 6 6
vertex -1 2.5 -1
vertex 1 2.5 -1
vertex -1 2.5 1
tri 0 1 2 mirrored
emission 0 0 0
diffuse .7 .6 .5
twosided true
plane -1  0 0 1
diffuse 0 0 0
specular .9 .9 .9
shininess 100000
refraction .9 .9 .9, 1.52
sphere -0.8 1 0.5 0.6
refraction off
shininess 1000000
sphere 0.8 1 0.5 0.6
"""

# One table each, and all of them: the kernel's loops over empty (one
# masked padding row) tables must be no-ops.
TRI_ONLY = """
size 16 16
recursion 3
camera 0 1 4  0 1 0  0 1 0  60
emission 6 6 6
vertex -1 2.5 -1
vertex 1 2.5 -1
vertex -1 2.5 1
tri 0 1 2 mirrored
emission 0 0 0
diffuse .7 .6 .5
specular .3 .3 .3
shininess 200
twosided true
vertex -3 0 -3
vertex 3 0 -3
vertex -3 0 3
tri 3 4 5 mirrored
"""

SPHERE_ONLY = """
size 16 16
recursion 3
ambient color 0.3 0.3 0.3
camera 0 1 4  0 1 0  0 1 0  60
emission 4 4 4
sphere 0 3 0 0.8
emission 0 0 0
diffuse .6 .6 .6
sphere 0 -50 0 50
diffuse 0 0 0
specular .9 .9 .9
shininess 100000
refraction .9 .9 .9, 1.52
sphere -0.8 1 0.5 0.6
"""

MIXED = SCENE.replace("recursion 4", "recursion 3")


def _rays(scene, seed):
    cam = init_camera(scene.cameras[0], scene.width, scene.height)
    px, py = cam_mod.pixel_grid(scene.width, scene.height)
    k_cam, k_path = jax.random.split(jax.random.PRNGKey(seed))
    ray_o, ray_d = cam_mod.camera_rays(cam, px, py, k_cam)
    return ray_o, ray_d, k_path


def _close(ref_c, got_c):
    return np.all(np.abs(ref_c - got_c) <= 1e-3 + 1e-3 * np.abs(ref_c),
                  axis=1)


@pytest.mark.parametrize("want_tape", [False, True],
                         ids=["color", "tape"])
@pytest.mark.parametrize("text", [TRI_ONLY, SPHERE_ONLY, MIXED],
                         ids=["tri_only", "sphere_only", "mixed"])
def test_megakernel_interpret_matches_trace(text, want_tape):
    """16x16 at recursion 3: colors and miss map agree with ``trace`` on
    shared uniforms; with ``want_tape`` the recorded codes agree too."""
    scene = loader.parse(text)
    arrays = freeze_scene(scene)
    ray_o, ray_d, k_path = _rays(scene, 5)
    uniforms = prepare_uniforms(k_path, ray_o.shape[0],
                                arrays.recursion + 1, jnp.float32)
    ref = trace(arrays, ray_o, ray_d, None, uniforms=uniforms,
                want_tape=want_tape)
    got = trace_fused(arrays, ray_o, ray_d, None, uniforms=uniforms,
                      want_tape=want_tape, interpret=True)
    assert len(got) == len(ref) == (3 if want_tape else 2)
    ref_c, got_c = np.asarray(ref[0]), np.asarray(got[0])
    assert got_c.shape == (256, 3) and np.isfinite(got_c).all()
    assert ref_c.max() > 0.1  # not vacuously black
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    assert _close(ref_c, got_c).mean() > 0.97
    if want_tape:
        code_ref = np.asarray(ref[2].flags & PathTape.CODE_MASK)
        code_k = np.asarray(got[2].flags & PathTape.CODE_MASK)
        assert got[2].prim.shape == (arrays.recursion + 1, 256)
        assert (code_ref == code_k).mean() > 0.99


def test_megakernel_block_padding():
    """A ray count that is not a multiple of the block is padded inside
    ``trace_fused`` and cut back; the result does not depend on the block."""
    scene = loader.parse(MIXED)
    arrays = freeze_scene(scene)
    ray_o, ray_d, k_path = _rays(scene, 2)
    ray_o, ray_d = ray_o[:200], ray_d[:200]
    a = trace_fused(arrays, ray_o, ray_d, k_path, interpret=True, block=64)
    b = trace_fused(arrays, ray_o, ray_d, k_path, interpret=True, block=128)
    assert a[0].shape == (200, 3) and a[1].shape == (200,)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def _trace_both(scene_text, seed):
    scene = loader.parse(scene_text)
    arrays = freeze_scene(scene)
    ray_o, ray_d, k_path = _rays(scene, seed)
    ref = trace(arrays, ray_o, ray_d, k_path)
    got = trace_fused(arrays, ray_o, ray_d, k_path, interpret=True)
    return ref, got


def test_trace_fused_matches_integrator():
    (ref_color, ref_miss), (got_color, got_miss) = _trace_both(SCENE, 7)

    ref_c = np.asarray(ref_color)
    got_c = np.asarray(got_color)
    # The scene must actually light up (guard against all-black vacuous
    # agreement).
    assert ref_c.max() > 0.5
    # Same stochastic paths ⇒ same miss classification everywhere.
    np.testing.assert_array_equal(np.asarray(got_miss), np.asarray(ref_miss))
    # 0.97 over 256 rays: f32 associativity differences between the kernel
    # and XLA can flip stochastic branch picks on knife-edge rays, so allow
    # a few whole-path divergences.
    close = _close(ref_c, got_c)
    assert close.mean() > 0.97, f"only {close.mean():.3f} of rays match"
    np.testing.assert_allclose(got_c.mean(0), ref_c.mean(0), rtol=5e-3,
                               atol=5e-3)


def test_trace_fused_ambient_miss_mode():
    # `ambient miss`: secondary misses count as miss samples.
    text = SCENE.replace("ambient color 0.05 0.05 0.05", "ambient miss")
    (ref_color, ref_miss), (got_color, got_miss) = _trace_both(text, 11)
    np.testing.assert_array_equal(np.asarray(got_miss), np.asarray(ref_miss))
    close = _close(np.asarray(ref_color), np.asarray(got_color))
    assert close.mean() > 0.97, f"only {close.mean():.3f} of rays match"


def test_kernel_tape_matches_trace_tape():
    """``want_tape=True``: the megakernel-recorded PathTape agrees with the
    integrator's own tape (codes everywhere; prim + full flags wherever the
    replay reads them), and the [R]-shaped replay re-walks the kernel's
    path to the exact colors the kernel produced — the contract the train
    step's megakernel recorder (replay.record_tape) relies on."""
    from raytracercore.render.replay import replay

    scene = loader.parse(SCENE)
    arrays = freeze_scene(scene)
    ray_o, ray_d, k_path = _rays(scene, 3)
    uniforms = prepare_uniforms(k_path, ray_o.shape[0],
                                arrays.recursion + 1, jnp.float32)

    _, m_ref, tape_ref = trace(arrays, ray_o, ray_d, None,
                               uniforms=uniforms, want_tape=True)
    c_k, m_k, tape_k = trace_fused(arrays, ray_o, ray_d, None,
                                   uniforms=uniforms, want_tape=True,
                                   interpret=True)

    code_ref = np.asarray(tape_ref.flags & PathTape.CODE_MASK)
    code_k = np.asarray(tape_k.flags & PathTape.CODE_MASK)
    # Codes must agree near-universally; knife-edge f32 branch flips between
    # backends are the only allowed source of disagreement (see
    # test_trace_fused_matches_integrator).
    agree = code_ref == code_k
    assert agree.mean() > 0.99, f"only {agree.mean():.3f} of codes match"
    nonskip = agree & (code_ref != 0)
    assert nonskip.any()
    np.testing.assert_array_equal(np.asarray(tape_ref.prim)[nonskip],
                                  np.asarray(tape_k.prim)[nonskip])
    # Full flag words (inside/Fresnel-live bits) where the replay reads
    # them: bounced codes (Diffuse=1, Specular=2, Transmitted=4).
    bounced = agree & np.isin(code_ref, (1, 2, 4))
    assert bounced.any()
    np.testing.assert_array_equal(np.asarray(tape_ref.flags)[bounced],
                                  np.asarray(tape_k.flags)[bounced])

    # The replay of the kernel's tape must land on the kernel's own colors
    # (exactly, when every code agrees — both walk the same decisions).
    c_rep, m_rep = replay(arrays, ray_o, ray_d, uniforms, tape_k)
    if agree.all():
        np.testing.assert_allclose(np.asarray(c_rep), np.asarray(c_k),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(m_rep), np.asarray(m_k))
    else:  # pragma: no cover - backend-dependent knife edges
        both = np.all(agree, axis=0)
        np.testing.assert_allclose(np.asarray(c_rep)[both],
                                   np.asarray(c_k)[both],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("want_tape", [False, True], ids=["color", "tape"])
def test_megakernel_lowers_to_triton_for_cuda(want_tape):
    """Lowering to Triton IR runs without a card: catch what the Triton
    route refuses (the interpreter accepts more) before the card's
    compiler sees the kernel."""
    from jax import export

    scene = loader.parse(MIXED.replace("recursion 3", "recursion 4"))
    arrays = freeze_scene(scene)
    ray_o, ray_d, k_path = _rays(scene, 1)
    fn = jax.jit(lambda o, d, k: trace_fused(arrays, o, d, k,
                                             want_tape=want_tape))
    exp = export.export(fn, platforms=["cuda"], disabled_checks=[
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
            ray_o, ray_d, k_path)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_megakernel_compiled_matches_trace(gpu):
    """The compiled kernel on the card against ``trace`` (the interpret
    tests above cannot see the card's compiler)."""
    import chip_smoke

    cmp = chip_smoke.phase_render(size=64, recursion=10, passes=1)
    assert cmp["samepick"] == 0
