"""The wavefront path-tracing integrator.

This is the batched rebuild of ``Raytracer.GetColor`` (Raytracing/Raytracer.cs:
65-246): instead of one recursive ray per pixel per thread, a whole batch of
rays advances through a ``lax.fori_loop`` over bounces; terminated rays are
masked out and their results frozen.  All reference semantics are preserved:

* direction renormalized every 3 bounces (Raytracer.cs:74-75)
* primary miss → "Placeholder" miss sample; secondary miss → the scene's
  ambient color returned UNTINTED (Raytracer.cs:85-90)
* ``debug geom`` mode: flat spec+diff+emission of the first hit (:93-98)
* rough shading normal: ``z = U^(1/shininess)`` cone sample around the true
  normal (RandomShine, :51-56)
* exact Fresnel s/p-wave average with total internal reflection, applied to
  the luminance-weighted branch probabilities (:120-157)
* single stochastic branch per bounce ∝ luminance: transmit / specular (with
  the rough-normal fail path) / diffuse (``z = 2·acos(U)/π``) / emission
  (:163-229); throughput multiplied by chosen albedo × ``max(totalLum, 1)``
  (:238-240); termination returns ``tint · emission`` (:245)
* self-intersection via the previous-hit skip record, not ray epsilons (:77)

Differentiability: branch *selection* is discrete (comparisons carry no
gradient); the realized path's albedo/Fresnel/totalLum factors stay on the
tape, so ``jax.grad`` of a pixel w.r.t. material parameters matches finite
differences of the same fixed-RNG estimator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core.pytree import PyTreeNode

from ..core import vecmath as vm
from ..core.color import luminance
from ..intersect.dispatch import HitRecord, closest_hit
from ..scene.types import SceneArrays

TWO_PI = 6.283185307179586


class BounceType:
    """Per-bounce tags (Raytracer.BounceType, Raytracer.cs:14-26)."""

    SKIPPED = 0
    DIFFUSE = 1
    SPECULAR = 2
    SPECULAR_FAIL = 3
    TRANSMITTED = 4
    EMISSION = 5
    PURE_BLACK = 6
    RECURSION_COMPLETE = 7
    MISSED = 8
    DEBUG = 9

    NAMES = ("Skipped", "Diffuse", "Specular", "SpecularFail", "Transmitted",
             "Emission", "PureBlack", "RecursionComplete", "Missed", "Debug")


class BounceRecords(PyTreeNode):
    """Per-bounce debug trace (the DebugRay records of Raytracer.cs:28-33),
    [R, recursion+1] per field."""

    btype: jnp.ndarray     # int32 BounceType
    prim: jnp.ndarray      # int32 hit primitive (-1 miss)
    t: jnp.ndarray         # hit distance
    position: jnp.ndarray  # [R, B, 3]
    normal: jnp.ndarray    # [R, B, 3]
    inside: jnp.ndarray    # bool
    fresnel: jnp.ndarray   # Fresnel ratio (NaN when not evaluated)

    @classmethod
    def create(cls, n, bounces, dtype=jnp.float32):
        return cls(
            btype=jnp.zeros((n, bounces), jnp.int32),
            prim=jnp.full((n, bounces), -1, jnp.int32),
            t=jnp.zeros((n, bounces), dtype),
            position=jnp.zeros((n, bounces, 3), dtype),
            normal=jnp.zeros((n, bounces, 3), dtype),
            inside=jnp.zeros((n, bounces), bool),
            fresnel=jnp.full((n, bounces), jnp.nan, dtype),
        )


class PathTape(PyTreeNode):
    """Compact per-bounce decision record for the path-replay backward.

    The stop-grad forward records the DISCRETE outcomes of each bounce —
    which primitive won the closest-hit query and which interaction branch
    was taken (the choices made by ``Raytracer.GetColor``'s comparisons,
    Raytracer.cs:163-229) — plus the hit NORMAL, which is a pure function
    of stop-gradded geometry.  The differentiable replay (:mod:`.replay`)
    then recomputes only the shading math on the recorded path: no
    selection, no winner re-evaluation, no [rays × prims] grids — gradients
    enter exclusively through the material table (shininess → rough
    normal, IOR → Fresnel/refraction, albedos/emission → tint), never
    through the recorded geometry.

    Normals are stored as separate [bounces, R] component planes (not
    [..., 3]) so the replay's column-oriented math reads full 128-lane
    rows; they are defined only on bounces whose code requires shading.

    ``flags`` bit layout: bits 0-3 = :class:`BounceType` code,
    bit 4 = hit ``inside`` (post-Invert), bit 5 = ``f_live``
    (Fresnel evaluated: refraction geometrically possible and no TIR).

    Bit-equality contract: ``prim`` and ``flags`` are only defined where
    the replay reads them — ``prim`` on live bounces, INSIDE/FLIVE bits on
    bounced codes.  The two recorders differ elsewhere (the megakernel
    writes prim = -1 / flags = 0 on dead lanes and omits FLIVE on the
    final bounce, while ``trace`` writes hit fields unconditionally); any
    new tape consumer must mask rather than assume recorder equivalence.
    """

    prim: jnp.ndarray   # [bounces, R] int32 winning primitive (-1 miss)
    flags: jnp.ndarray  # [bounces, R] int32 bitfield
    nx: jnp.ndarray     # [bounces, R] hit normal components (see class doc)
    ny: jnp.ndarray
    nz: jnp.ndarray

    FLAG_INSIDE = 1 << 4
    FLAG_FLIVE = 1 << 5
    CODE_MASK = 0xF

    @classmethod
    def create(cls, n, bounces, dtype=jnp.float32):
        z = lambda: jnp.zeros((bounces, n), dtype)
        return cls(prim=jnp.full((bounces, n), -1, jnp.int32),
                   flags=jnp.zeros((bounces, n), jnp.int32),
                   nx=z(), ny=z(), nz=z())


class PathState(PyTreeNode):
    ray_o: jnp.ndarray    # [R, 3]
    ray_d: jnp.ndarray    # [R, 3]
    tint: jnp.ndarray     # [R, 3] running throughput
    alive: jnp.ndarray    # [R] bool — still bouncing
    result: jnp.ndarray   # [R, 3] final color once dead
    miss: jnp.ndarray     # [R] bool — sample counts as a miss
    prev: HitRecord       # previous bounce's hit (skip record)


def prepare_uniforms(key, n, bounces, dtype=jnp.float32):
    """All per-bounce randomness, preprocessed: [bounces, 7, n].

    Bounce ``i`` draws ``uniform(fold_in(key, i), (n, 5))`` — the integrator's
    historical consumption order (shine z, shine θ, branch u, diffuse z,
    diffuse θ; Raytracer.cs:51-56, 177, 215-216) — then applies every
    transform that is a pure function of the uniform:

      ch0 = ln(clip(u0))          — RandomShine exponent input
      ch1, ch2 = cos/sin(2π·u1)   — shine azimuth
      ch3 = u2                    — branch-selection variate
      ch4 = 2·acos(u3)/π          — diffuse cone height (Raytracer.cs:215)
      ch5, ch6 = cos/sin(2π·u4)   — diffuse azimuth

    Hoisting the transcendentals here keeps them out of the bounce loop (and
    out of the megakernel, which only needs FMA-class ops plus one exp for
    the shininess power).
    """
    def one(i):
        u = jax.random.uniform(jax.random.fold_in(key, i), (n, 5),
                               dtype=dtype)
        t1 = u[:, 1] * TWO_PI
        t2 = u[:, 4] * TWO_PI
        return jnp.stack([
            jnp.log(jnp.clip(u[:, 0], 1e-20, 1.0)),
            jnp.cos(t1), jnp.sin(t1),
            u[:, 2],
            2.0 * jnp.arccos(jnp.clip(u[:, 3], 0.0, 1.0)) / jnp.pi,
            jnp.cos(t2), jnp.sin(t2),
        ])

    return jnp.stack([one(i) for i in range(bounces)])


def _random_shine(ln_u, cos_t, sin_t, normal, shininess):
    """RandomShine (Raytracer.cs:51-56): perturb the shading normal on a cone
    with ``z = U^(1/shininess)`` = exp(ln U / shininess); shininess=+inf ⇒
    z=1 (unperturbed).  ``ln_u`` is pre-clipped away from ln(0) so the
    backward pass through the exp stays finite."""
    z = jnp.where(jnp.isinf(shininess), 1.0, jnp.exp(ln_u / shininess))
    return vm.create_horizon_cs(normal, z, cos_t, sin_t)


# Gather-by-matmul threshold: tables of at most this many rows are gathered
# by a one-hot matmul, larger ones by ``jnp.take``.
ONEHOT_MAX_ROWS = 1024


def gather_rows(mat, idx):
    """Row gather ``mat[idx]`` ([rows, C] by [R] int): one-hot matmul (its
    transpose — the backward scatter-add — is another matmul) for small
    tables, ``jnp.take`` beyond :data:`ONEHOT_MAX_ROWS`.

    precision=HIGHEST is load-bearing: a float32 matmul on the GPU may
    otherwise run in TF32, which rounds the gathered values to about three
    decimal digits even though the one-hot factor is exact.  HIGHEST makes
    the one-hot matmul an exact row copy."""
    n = mat.shape[0]
    if n <= ONEHOT_MAX_ROWS:
        onehot = (idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]
                  ).astype(mat.dtype)
        return jnp.matmul(onehot, mat, precision=jax.lax.Precision.HIGHEST)
    return jnp.take(mat, idx, axis=0)


def _material_matrix(mats):
    """Materials packed [N, 14]: emission diffuse specular refraction ×3,
    ior, shininess.  Infinite shininess is clamped to f32-max so the one-hot
    matmul stays NaN-free (0·inf); ``exp(ln U / 3.4e38)`` rounds to exactly
    1.0f, identical to the explicit isinf branch in :func:`_random_shine`."""
    shin = mats.shininess
    shin = jnp.where(jnp.isinf(shin), jnp.finfo(jnp.float32).max, shin)
    return jnp.concatenate([
        mats.emission, mats.diffuse, mats.specular, mats.refraction,
        mats.refractive_index[:, None], shin[:, None]], axis=1)


def _split_material(m):
    return {
        "emission": m[:, 0:3],
        "diffuse": m[:, 3:6],
        "specular": m[:, 6:9],
        "refraction": m[:, 9:12],
        "ior": m[:, 12],
        "shininess": m[:, 13],
    }


def _gather_material(mats, prim):
    return _split_material(gather_rows(_material_matrix(mats),
                                       jnp.maximum(prim, 0)))


def trace(scene: SceneArrays, ray_o, ray_d, key,
          closest_fn=closest_hit, record: bool = False,
          early_exit: bool = False, uniforms=None,
          want_tape: bool = False):
    """Trace a batch of camera rays to final colors.

    Args:
      scene: frozen SceneArrays.
      ray_o, ray_d: [R, 3] camera rays (unit directions).
      key: PRNG key for this batch; bounce ``i`` consumes
        ``fold_in(key, i)``.
      closest_fn: closest-hit implementation (brute or BVH).
      record: also return per-bounce :class:`BounceRecords` (the
        GetDebugTrace path, Raytracer.cs:254-260) — same loop body, so the
        debug view can never drift from the render path.
      early_exit: stop the bounce loop once every ray has terminated
        (lax.while_loop).  Forward-only — while_loop has no reverse rule;
        keep False under jax.grad.
      uniforms: pre-generated :func:`prepare_uniforms` output to use instead
        of drawing from ``key`` (the replay path shares one uniform set
        between the recording and replay passes).
      want_tape: also return a :class:`PathTape` of per-bounce discrete
        decisions (recorded through the SAME loop body, so the tape can
        never drift from the render path).

    Returns:
      (color [R, 3], miss [R] bool) — ``miss`` marks Placeholder samples
      (primary miss, or any miss under ``ambient miss``); with
      ``record=True`` a :class:`BounceRecords` is appended, and with
      ``want_tape=True`` a :class:`PathTape` is appended (in that order).
    """
    R = ray_o.shape[0]
    dtype = ray_o.dtype
    ambient = scene.ambient_rgb.astype(dtype)

    state = PathState(
        ray_o=ray_o,
        ray_d=ray_d,
        tint=jnp.ones((R, 3), dtype),
        alive=jnp.ones((R,), bool),
        result=jnp.zeros((R, 3), dtype),
        miss=jnp.zeros((R,), bool),
        prev=HitRecord.none(R, dtype),
    )

    recursion = scene.recursion
    # All randomness for the whole trace, generated up front (bounce i reads
    # uniforms[i]); the key schedule (fold_in(key, i) per bounce) matches the
    # docstring contract above.
    if uniforms is None:
        uniforms = prepare_uniforms(key, R, recursion + 1, dtype)

    def body(i, carry):
        state, records, tape = carry
        # Periodic renormalization (Raytracer.cs:74-75).
        d = jnp.where(i % 3 == 0, vm.normalize(state.ray_d), state.ray_d)

        # named_scope: xprof-visible phase annotations (SURVEY §5.1 — the
        # reference's only profiling is a stopwatch per tile).
        with jax.named_scope("closest_hit"):
            hit = closest_fn(scene, state.ray_o, d, state.prev)
        active = state.alive
        found = hit.found

        # --- miss handling (Raytracer.cs:81-91) -------------------------
        m_primary = active & ~found & (i == 0)
        m_secondary = active & ~found & (i != 0)
        result = state.result
        miss = state.miss | m_primary
        if scene.ambient_is_miss:
            miss = miss | m_secondary
        else:
            result = jnp.where(m_secondary[:, None], ambient, result)
        alive = active & found

        mat = _gather_material(scene.materials, hit.prim)
        emission = mat["emission"]

        # --- recursion complete (Raytracer.cs:100-104) ------------------
        done = alive & (i >= recursion)
        result = jnp.where(done[:, None], state.tint * emission, result)
        alive = alive & ~done

        # --- shading (only meaningful where alive) ----------------------
        u = uniforms[i]  # [7, R] preprocessed channels

        rough_n = _random_shine(u[0], u[1], u[2], hit.normal,
                                mat["shininess"])

        diff_lum = luminance(mat["diffuse"])
        spec_lum = luminance(mat["specular"])
        refr_lum = luminance(mat["refraction"])
        emis_lum = luminance(emission)

        cos = -vm.dot(rough_n, d)

        # Fresnel split (Raytracer.cs:120-157).
        can_refract = ((refr_lum > 0) | (spec_lum > 0)) & \
            (mat["ior"] != 0) & (cos >= 0)
        ior_in = jnp.where(hit.inside, mat["ior"],
                           scene.air_refractive_index.astype(dtype))
        ior_out = jnp.where(hit.inside,
                            scene.air_refractive_index.astype(dtype),
                            mat["ior"])
        safe_out = jnp.where(ior_out == 0, 1.0, ior_out)
        ior_ratio = ior_in / safe_out
        sin_out = ior_ratio * vm.safe_sqrt(1.0 - cos * cos)
        tir = sin_out >= 1.0
        cos_out = vm.safe_sqrt(1.0 - sin_out * sin_out)
        # Fresnel terms evaluated with masked inputs: where refraction is
        # impossible (cos<0, ior=0, TIR) the raw denominators can pass
        # through 0 and rs² overflows to inf, which NaNs the backward pass
        # through jnp.where even though the branch is unselected.
        f_live = can_refract & ~tir
        cos_f = jnp.where(f_live, cos, 1.0)
        cos_out_f = jnp.where(f_live, cos_out, 1.0)
        rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / \
            ((ior_out * cos_f) + (ior_in * cos_out_f))
        rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / \
            ((ior_in * cos_f) + (ior_out * cos_out_f))
        fresnel = (rs * rs + rp * rp) / 2.0

        spec_lum = jnp.where(can_refract & ~tir,
                             spec_lum * fresnel, spec_lum)
        refr_lum = jnp.where(can_refract & ~tir,
                             refr_lum * (1.0 - fresnel),
                             jnp.zeros_like(refr_lum))

        total_lum = diff_lum + spec_lum + refr_lum + emis_lum

        # Pure black termination (Raytracer.cs:165-169).
        black = alive & (total_lum <= 0)
        result = jnp.where(black[:, None], state.tint * emission, result)
        alive = alive & ~black

        # --- stochastic branch selection (Raytracer.cs:177-229) ---------
        ray_rand = u[3] * total_lum
        pick_refr = (refr_lum != 0) & (ray_rand - refr_lum <= 0)
        r2 = ray_rand - refr_lum
        pick_spec = ~pick_refr & (spec_lum != 0) & (r2 - spec_lum <= 0)
        r3 = r2 - spec_lum
        pick_diff = ~pick_refr & ~pick_spec & (diff_lum != 0) & \
            (r3 - diff_lum <= 0)
        pick_emit = ~pick_refr & ~pick_spec & ~pick_diff

        # Transmission (Raytracer.cs:181-193).
        refr_dir = (rough_n * (-cos_out)[:, None]
                    + (d + rough_n * cos[:, None]) * ior_ratio[:, None])
        refr_tint = jnp.where(hit.inside[:, None],
                              jnp.ones_like(mat["refraction"]),
                              mat["refraction"])

        # Specular with rough-normal fail (Raytracer.cs:194-209).
        spec_dir = vm.reflect(rough_n, d, cos)
        spec_ok = vm.dot(spec_dir, hit.normal) > 0

        # Diffuse (Raytracer.cs:210-219): z = 2·acos(U)/π around the TRUE
        # normal (not the rough normal); z precomputed as channel 4.
        diff_dir = vm.create_horizon_cs(hit.normal, u[4], u[5], u[6])

        # Terminal branches: emission pick, or failed specular.
        terminal = alive & (pick_emit | (pick_spec & ~spec_ok))
        result = jnp.where(terminal[:, None], state.tint * emission, result)
        alive = alive & ~terminal

        out_dir = jnp.where(pick_refr[:, None], refr_dir,
                            jnp.where(pick_spec[:, None], spec_dir,
                                      diff_dir))
        new_tint = jnp.where(pick_refr[:, None], refr_tint,
                             jnp.where(pick_spec[:, None], mat["specular"],
                                       mat["diffuse"]))
        # Energy compensation (Raytracer.cs:238-240).
        new_tint = new_tint * jnp.maximum(total_lum, 1.0)[:, None]

        bounced = alive
        sel = bounced[:, None]
        ray_o = jnp.where(sel, hit.position, state.ray_o)
        ray_d = jnp.where(sel, out_dir, d)
        # Park dead lanes far outside any scene, pointing away: their
        # results are already committed, and a parked ray misses every
        # AABB/primitive — so dead lanes leave the BVH walk at the root
        # instead of lengthening its lockstep loop.  (Lanes keep running —
        # this is not compaction — but their select work short-circuits.)
        parked_o = jnp.asarray([4e8, 4e8, 4e8], dtype)
        parked_d = jnp.asarray([1.0, 0.0, 0.0], dtype)
        ray_o = jnp.where(alive[:, None], ray_o, parked_o)
        ray_d = jnp.where(alive[:, None], ray_d, parked_d)
        tint = jnp.where(sel, state.tint * new_tint, state.tint)

        prev = HitRecord(
            prim=jnp.where(bounced, hit.prim, state.prev.prim),
            t=jnp.where(bounced, hit.t, state.prev.t),
            position=jnp.where(sel, hit.position, state.prev.position),
            normal=jnp.where(sel, hit.normal, state.prev.normal),
            inside=jnp.where(bounced, hit.inside, state.prev.inside),
        )

        new_state = PathState(ray_o=ray_o, ray_d=ray_d, tint=tint,
                              alive=alive, result=result, miss=miss,
                              prev=prev)

        if records is not None or tape is not None:
            btype = jnp.full_like(hit.prim, BounceType.SKIPPED)
            set_t = lambda bt, m, cur: jnp.where(m, bt, cur)
            btype = set_t(BounceType.MISSED, m_primary | m_secondary, btype)
            btype = set_t(BounceType.RECURSION_COMPLETE, done, btype)
            btype = set_t(BounceType.PURE_BLACK, black, btype)
            btype = set_t(BounceType.EMISSION,
                          (terminal & pick_emit), btype)
            btype = set_t(BounceType.SPECULAR_FAIL,
                          (terminal & pick_spec & ~spec_ok), btype)
            btype = set_t(BounceType.TRANSMITTED, bounced & pick_refr, btype)
            btype = set_t(BounceType.SPECULAR, bounced & pick_spec, btype)
            btype = set_t(BounceType.DIFFUSE, bounced & pick_diff, btype)

        if tape is not None:
            flags = (btype
                     | jnp.where(hit.inside, PathTape.FLAG_INSIDE, 0)
                     | jnp.where(f_live, PathTape.FLAG_FLIVE, 0))
            tape = PathTape(prim=tape.prim.at[i].set(hit.prim),
                            flags=tape.flags.at[i].set(flags),
                            nx=tape.nx.at[i].set(hit.normal[:, 0]),
                            ny=tape.ny.at[i].set(hit.normal[:, 1]),
                            nz=tape.nz.at[i].set(hit.normal[:, 2]))

        if records is not None:
            fr = jnp.where(active & can_refract,
                           jnp.where(tir, 1.0, fresnel), jnp.nan)
            touched = active
            records = BounceRecords(
                btype=records.btype.at[:, i].set(
                    jnp.where(touched, btype, records.btype[:, i])),
                prim=records.prim.at[:, i].set(
                    jnp.where(touched, hit.prim, records.prim[:, i])),
                t=records.t.at[:, i].set(
                    jnp.where(touched, hit.t, records.t[:, i])),
                position=records.position.at[:, i].set(
                    jnp.where(touched[:, None], hit.position,
                              records.position[:, i])),
                normal=records.normal.at[:, i].set(
                    jnp.where(touched[:, None], hit.normal,
                              records.normal[:, i])),
                inside=records.inside.at[:, i].set(
                    jnp.where(touched, hit.inside, records.inside[:, i])),
                fresnel=records.fresnel.at[:, i].set(fr),
            )

        return new_state, records, tape

    if scene.debug_geom:
        # Flat geometry view (Raytracer.cs:93-98): first hit's
        # spec+diff+emission; primary misses stay misses.
        hit = closest_fn(scene, state.ray_o, state.ray_d, None)
        mat = _gather_material(scene.materials, hit.prim)
        color = mat["specular"] + mat["diffuse"] + mat["emission"]
        color = jnp.where(hit.found[:, None], color, 0.0)
        extras = []
        if want_tape:
            tape = PathTape.create(R, recursion + 1, dtype)
            code = jnp.where(hit.found, BounceType.DEBUG, BounceType.MISSED)
            extras = [tape.replace(prim=tape.prim.at[0].set(hit.prim),
                                   flags=tape.flags.at[0].set(code))]
        if record:
            records = BounceRecords.create(R, recursion + 1, dtype)
            records = records.replace(
                btype=records.btype.at[:, 0].set(
                    jnp.where(hit.found, BounceType.DEBUG,
                              BounceType.MISSED)),
                prim=records.prim.at[:, 0].set(hit.prim),
                t=records.t.at[:, 0].set(hit.t),
                position=records.position.at[:, 0].set(hit.position),
                normal=records.normal.at[:, 0].set(hit.normal),
                inside=records.inside.at[:, 0].set(hit.inside))
            return (color, ~hit.found, records, *extras)
        return (color, ~hit.found, *extras)

    records = BounceRecords.create(R, recursion + 1, dtype) if record \
        else None
    tape = PathTape.create(R, recursion + 1, dtype) if want_tape else None
    if early_exit:
        # Most paths terminate well before the recursion cap (emission pick,
        # pure-black, specular fail); stop as soon as the whole wavefront is
        # dead instead of tracing empty bounces.
        def w_cond(carry):
            i, (st, _, _) = carry
            return (i < recursion + 1) & jnp.any(st.alive)

        def w_body(carry):
            i, sr = carry
            return i + 1, body(i, sr)

        _, (state, records, tape) = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), (state, records, tape)))
    else:
        # Rematerialize each bounce in the backward pass: without this,
        # reverse AD saves every per-bounce intersection grid
        # ([bounces, R, prims] residuals — hundreds of MB at 700², the HBM
        # killer).  Recomputing a bounce is cheap relative to HBM traffic
        # (SURVEY §7 design stance: jax.checkpoint trades FLOPs for memory).
        body_ck = jax.checkpoint(body, prevent_cse=False)
        state, records, tape = jax.lax.fori_loop(
            0, recursion + 1, body_ck, (state, records, tape))
    out = (state.result, state.miss)
    if record:
        out = out + (records,)
    if want_tape:
        out = out + (tape,)
    return out
