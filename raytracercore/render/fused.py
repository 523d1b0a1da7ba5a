"""Whole-path megakernel: the complete bounce loop in one Triton kernel.

One kernel call renders a full progressive pass: camera rays enter, final
colors leave.  Every bounce — closest hit over all primitive tables
(Scene.RayTracePrimitives, Scene.cs:65-111), material fetch, Fresnel/TIR
split, stochastic branch selection and path-state update (the whole of
``Raytracer.GetColor``, Raytracer.cs:65-246) — runs inside the kernel, with
each ray's path state in registers.  The XLA integrator
(:func:`..render.integrator.trace`) pays a round trip through device memory
and several kernel launches per bounce; here nothing leaves the SM between
bounces.  ``trace`` stays the differentiable reference: both consume the
preprocessed uniforms of :func:`..render.integrator.prepare_uniforms`.

Design for Hopper (Pallas through Triton):

* each program owns a power-of-two block of rays (:data:`BLOCK`) held as
  flat component vectors;
* primitive and material tables (a few KB) are read with scalar loads from
  device memory and stay in L1/L2; the material fetch is a per-ray gather;
* the bounce loop and the loop over table rows are ``lax.fori_loop``, so the
  kernel's size does not grow with the recursion depth or the scene;
* uniforms are drawn outside the kernel (``prepare_uniforms``).

Forward-only: branch selection is not reverse-mode differentiable.  Training
records a :class:`..render.integrator.PathTape` here (``want_tape=True``) and
differentiates the [R]-shaped replay (:mod:`.replay`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import vecmath as vm
from ..core.color import LUM_B, LUM_G, LUM_R
from ..intersect import kernel_body as kb
from ..scene.types import SceneArrays

# Rays per program and warps per program, tuned on the card (PERF.md).
BLOCK = 256
NUM_WARPS = 4

SC_F = 4    # air_ior, ambient r g b


def _pack_materials(mats):
    """[N, 14]: emission(3) diffuse(3) specular(3) refraction(3) ior shin."""
    return jnp.concatenate([
        mats.emission, mats.diffuse, mats.specular, mats.refraction,
        mats.refractive_index[:, None], mats.shininess[:, None],
    ], axis=1).astype(jnp.float32)


def _make_kernel(recursion: int, eps_behind: float, eps_pos: float,
                 ambient_is_miss: bool, want_tape: bool, any_smooth: bool,
                 coplanar: bool):
    from .integrator import BounceType as BT
    from .integrator import PathTape

    def kernel(ox, oy, oz, dx, dy, dz, u_ref, tf, ti, sf, si, pf, pi,
               mf, scf, rr_o, rg_o, rb_o, miss_o, *tape_refs):
        tables = (tf, ti, sf, si, pf, pi)
        o0 = (ox[...], oy[...], oz[...])
        zero = jnp.zeros_like(o0[0])
        one = jnp.ones_like(zero)
        air = scf[0, 0]
        amb = (scf[0, 1], scf[0, 2], scf[0, 3])

        def hit_and_misses(i, o, d, alive, result, miss, pv):
            """Closest hit plus the miss handling (Raytracer.cs:81-91)."""
            skip = {"prim": pv[0], "px": pv[1][0], "py": pv[1][1],
                    "pz": pv[1][2], "nx": pv[2][0], "ny": pv[2][1],
                    "nz": pv[2][2], "inside": pv[3]}
            best = kb.closest_in_block(
                tables, o, d, kb.make_skip_match(d, skip, eps_pos),
                eps_behind, coplanar=coplanar, any_smooth=any_smooth)
            found = best[1] >= 0
            missed = alive & ~found
            if ambient_is_miss:
                miss = miss | missed
            else:
                miss = miss | (missed & (i == 0))
                result = vm.where3(missed & (i != 0), amb, result)
            return best, missed, alive & found, result, miss

        def write_tape(i, active, code, best, f_live=None):
            tp_o, tfl_o, tnx_o, tny_o, tnz_o = tape_refs
            flags = code | jnp.where(best[2], PathTape.FLAG_INSIDE, 0)
            if f_live is not None:
                flags = flags | jnp.where(f_live, PathTape.FLAG_FLIVE, 0)
            tp_o[i, :] = jnp.where(active, best[1], -1)
            tfl_o[i, :] = jnp.where(active, flags, 0)
            tnx_o[i, :] = best[4][0]
            tny_o[i, :] = best[4][1]
            tnz_o[i, :] = best[4][2]

        def renorm(due, d):
            # Periodic renormalization (Raytracer.cs:74-75), with the same
            # divide as trace.
            n = jnp.sqrt(vm.dot3(d, d))
            return vm.where3(due, (d[0] / n, d[1] / n, d[2] / n), d)

        def bounce(i, carry):
            # ``phase`` is i % 3, carried: Triton lowers no integer
            # remainder of the loop index.
            phase, o, d, tint, alive, result, miss, pv = carry
            d = renorm(phase == 0, d)
            best, missed, alive, result, miss = hit_and_misses(
                i, o, d, alive, result, miss, pv)
            active = alive | missed
            _, prim, inside, hit_pos, hit_nrm = best

            # --- material fetch: one gather per column --------------------
            safe = jnp.maximum(prim, 0)
            g = lambda k: mf[safe, k]
            emis = (g(0), g(1), g(2))
            diff = (g(3), g(4), g(5))
            spec = (g(6), g(7), g(8))
            refr = (g(9), g(10), g(11))
            ior, shin = g(12), g(13)
            lum = lambda c: LUM_R * c[0] + LUM_G * c[1] + LUM_B * c[2]
            l_e, l_d, l_s, l_r = lum(emis), lum(diff), lum(spec), lum(refr)
            te = (tint[0] * emis[0], tint[1] * emis[1], tint[2] * emis[2])

            # --- shading ---------------------------------------------------
            u = lambda ch: u_ref[i * 7 + ch, :]
            # RandomShine (Raytracer.cs:51-56): z = exp(ln U / shininess).
            z_shine = jnp.where(jnp.isinf(shin), 1.0, jnp.exp(u(0) / shin))
            rough_n = vm.create_horizon3_cs(hit_nrm, z_shine, u(1), u(2))
            cos = -vm.dot3(rough_n, d)

            # Fresnel split (Raytracer.cs:120-157).
            can_refract = ((l_r > 0) | (l_s > 0)) & (ior != 0) & (cos >= 0)
            ior_in = jnp.where(inside, ior, air)
            ior_out = jnp.where(inside, air, ior)
            safe_out = jnp.where(ior_out == 0, 1.0, ior_out)
            ior_ratio = ior_in / safe_out
            sin_out = ior_ratio * vm.safe_sqrt(1.0 - cos * cos)
            tir = sin_out >= 1.0
            cos_out = vm.safe_sqrt(1.0 - sin_out * sin_out)
            f_live = can_refract & ~tir
            cos_f = jnp.where(f_live, cos, 1.0)
            cos_out_f = jnp.where(f_live, cos_out, 1.0)
            rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / \
                ((ior_out * cos_f) + (ior_in * cos_out_f))
            rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / \
                ((ior_in * cos_f) + (ior_out * cos_out_f))
            fresnel = (rs * rs + rp * rp) / 2.0

            spec_lum = jnp.where(f_live, l_s * fresnel, l_s)
            refr_lum = jnp.where(f_live, l_r * (1.0 - fresnel), 0.0)
            total_lum = l_d + spec_lum + refr_lum + l_e

            # Pure black termination (Raytracer.cs:165-169).
            black = alive & (total_lum <= 0)
            result = vm.where3(black, te, result)
            alive = alive & ~black

            # --- stochastic branch selection (Raytracer.cs:177-229) ------
            ray_rand = u(3) * total_lum
            pick_refr = (refr_lum != 0) & (ray_rand - refr_lum <= 0)
            r2 = ray_rand - refr_lum
            pick_spec = ~pick_refr & (spec_lum != 0) & (r2 - spec_lum <= 0)
            r3 = r2 - spec_lum
            pick_diff = (~pick_refr & ~pick_spec & (l_d != 0)
                         & (r3 - l_d <= 0))
            pick_emit = ~pick_refr & ~pick_spec & ~pick_diff

            # Transmission (Raytracer.cs:181-193).
            refr_dir = tuple(
                rough_n[k] * (-cos_out) + (d[k] + rough_n[k] * cos)
                * ior_ratio for k in range(3))
            refr_tint = vm.where3(inside, (one, one, one), refr)
            # Specular with rough-normal fail (Raytracer.cs:194-209).
            spec_dir = vm.reflect3(rough_n, d, cos)
            spec_ok = vm.dot3(spec_dir, hit_nrm) > 0
            # Diffuse (Raytracer.cs:210-219) around the TRUE normal.
            diff_dir = vm.create_horizon3_cs(hit_nrm, u(4), u(5), u(6))

            # Terminal branches: emission pick, or failed specular.
            terminal = alive & (pick_emit | (pick_spec & ~spec_ok))
            result = vm.where3(terminal, te, result)
            alive = alive & ~terminal

            out_dir = vm.where3(pick_refr, refr_dir,
                                vm.where3(pick_spec, spec_dir, diff_dir))
            new_tint = vm.where3(pick_refr, refr_tint,
                                 vm.where3(pick_spec, spec, diff))
            # Energy compensation (Raytracer.cs:238-240).
            new_tint = vm.scale3(new_tint, jnp.maximum(total_lum, 1.0))

            bounced = alive
            if want_tape:
                code = jnp.where(missed, BT.MISSED, BT.SKIPPED)
                code = jnp.where(black, BT.PURE_BLACK, code)
                code = jnp.where(terminal & pick_emit, BT.EMISSION, code)
                code = jnp.where(terminal & pick_spec & ~spec_ok,
                                 BT.SPECULAR_FAIL, code)
                code = jnp.where(bounced & pick_refr, BT.TRANSMITTED, code)
                code = jnp.where(bounced & pick_spec, BT.SPECULAR, code)
                code = jnp.where(bounced & pick_diff, BT.DIFFUSE, code)
                write_tape(i, active, code, best, f_live)
            o = vm.where3(bounced, hit_pos, o)
            d = vm.where3(bounced, out_dir, d)
            tint = vm.where3(bounced, (tint[0] * new_tint[0],
                                       tint[1] * new_tint[1],
                                       tint[2] * new_tint[2]), tint)
            pv = (jnp.where(bounced, prim, pv[0]),
                  vm.where3(bounced, hit_pos, pv[1]),
                  vm.where3(bounced, hit_nrm, pv[2]),
                  jnp.where(bounced, inside, pv[3]))
            phase = jnp.where(phase == 2, 0, phase + 1)
            return phase, o, d, tint, alive, result, miss, pv

        init = (jnp.int32(0), o0, (dx[...], dy[...], dz[...]), (one, one, one),
                jnp.ones(zero.shape, bool), (zero, zero, zero),
                jnp.zeros(zero.shape, bool),
                (jnp.full(zero.shape, -1, jnp.int32), (zero, zero, zero),
                 (zero, zero, one), jnp.zeros(zero.shape, bool)))
        _, o, d, tint, alive, result, miss, pv = jax.lax.fori_loop(
            0, recursion, bounce, init)

        # Final bounce: recursion complete (Raytracer.cs:100-104) needs
        # only the emission of the hit.
        i = recursion
        d = renorm(i % 3 == 0, d)
        best, missed, alive, result, miss = hit_and_misses(
            i, o, d, alive, result, miss, pv)
        safe = jnp.maximum(best[1], 0)
        result = vm.where3(alive, (tint[0] * mf[safe, 0],
                                   tint[1] * mf[safe, 1],
                                   tint[2] * mf[safe, 2]), result)
        if want_tape:
            # No shading on the final bounce, so no FLIVE bit.
            code = jnp.where(missed, BT.MISSED,
                             jnp.where(alive, BT.RECURSION_COMPLETE,
                                       BT.SKIPPED))
            write_tape(i, alive | missed, code, best)
        rr_o[...] = result[0]
        rg_o[...] = result[1]
        rb_o[...] = result[2]
        miss_o[...] = miss.astype(jnp.int32)

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "recursion", "eps_behind", "eps_pos", "ambient_is_miss", "interpret",
    "want_tape", "any_smooth", "coplanar", "block", "num_warps"))
def _run(rays, u, tables, mf, scf, *, recursion, eps_behind, eps_pos,
         ambient_is_miss, interpret, want_tape, any_smooth, coplanar,
         block, num_warps):
    m = rays[0].shape[0]
    n_bounces = recursion + 1
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    row_spec = lambda rows: pl.BlockSpec((rows, block), lambda i: (0, i))
    f32 = jax.ShapeDtypeStruct((m,), jnp.float32)
    out_shape = [f32, f32, f32, jax.ShapeDtypeStruct((m,), jnp.int32)]
    out_specs = [ray_spec] * 4
    if want_tape:
        tape = lambda dt: jax.ShapeDtypeStruct((n_bounces, m), dt)
        out_shape += [tape(jnp.int32), tape(jnp.int32), tape(jnp.float32),
                      tape(jnp.float32), tape(jnp.float32)]
        out_specs += [row_spec(n_bounces)] * 5
    kernel = _make_kernel(recursion, eps_behind, eps_pos, ambient_is_miss,
                          want_tape, any_smooth, coplanar)
    return pl.pallas_call(
        kernel,
        grid=(m // block,),
        in_specs=[ray_spec] * 6 + [row_spec(u.shape[0])]
        + [whole(a) for a in (*tables, mf, scf)],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="trace_megakernel",
    )(*rays, u, *tables, mf, scf)


def trace_fused(scene: SceneArrays, ray_o, ray_d, key, interpret=False,
                uniforms=None, want_tape=False, block=None, num_warps=None):
    """Drop-in forward replacement for :func:`..render.integrator.trace`
    (same (color, miss) contract, same uniform consumption).

    ``uniforms``: pre-generated :func:`..render.integrator.prepare_uniforms`
    output ([bounces, 7, R]) to consume instead of drawing from ``key`` —
    the train path shares one uniform set between recording and replay.
    ``want_tape``: also return a :class:`..render.integrator.PathTape` of
    per-bounce discrete decisions, recorded inside the kernel.
    ``interpret``: run the kernel in the Pallas interpreter (tests on the
    CPU); otherwise it is compiled for the GPU.
    """
    from ..config import FUSED_COPLANAR_BRANCH
    from ..intersect.dispatch import _position_eps
    from .integrator import PathTape, prepare_uniforms

    block = block or BLOCK
    dtype = ray_o.dtype
    R = ray_o.shape[0]
    n_bounces = scene.recursion + 1
    pad = (-R) % block

    if uniforms is None:
        uniforms = prepare_uniforms(key, R, n_bounces, jnp.float32)
    u = jnp.pad(uniforms.astype(jnp.float32).reshape(n_bounces * 7, R),
                ((0, 0), (0, pad)))
    # Padding lanes get a unit direction so they stay finite.
    rays = tuple(jnp.pad(a[:, k].astype(jnp.float32), (0, pad),
                         constant_values=float(a is ray_d and k == 0))
                 for a in (ray_o, ray_d) for k in range(3))
    tables = tuple(a.astype(jnp.float32) if a.dtype != jnp.int32 else a
                   for a in kb.pack_tables(scene))
    mf = _pack_materials(scene.materials)
    scf = jnp.concatenate([
        scene.air_refractive_index.reshape(1).astype(jnp.float32),
        scene.ambient_rgb.reshape(3).astype(jnp.float32)]).reshape(1, SC_F)

    out = _run(rays, u, tables, mf, scf, recursion=scene.recursion,
               eps_behind=float(vm.near_enough(jnp.float32)),
               eps_pos=float(_position_eps(jnp.float32)),
               ambient_is_miss=scene.ambient_is_miss,
               interpret=bool(interpret), want_tape=want_tape,
               any_smooth=scene.any_smooth, coplanar=FUSED_COPLANAR_BRANCH,
               block=block, num_warps=num_warps or NUM_WARPS)
    rr, rg, rb, miss = out[:4]
    color = jnp.stack([rr[:R], rg[:R], rb[:R]], axis=1).astype(dtype)
    miss = miss[:R] != 0
    if want_tape:
        tape = PathTape(prim=out[4][:, :R], flags=out[5][:, :R],
                        nx=out[6][:, :R].astype(dtype),
                        ny=out[7][:, :R].astype(dtype),
                        nz=out[8][:, :R].astype(dtype))
        return color, miss, tape
    return color, miss
