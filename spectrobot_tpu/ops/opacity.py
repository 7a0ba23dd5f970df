"""Opacity accumulation (component C6, SURVEY.md) — two-stage design.

Stage 1 (:func:`line_kernel_inputs`, the "kernel prologue" of SURVEY.md C3):
per-line physics — strength T-scaling, widths, pressure shift, non-LTE and
column weights — producing the minimal flat arrays the accumulator consumes:

    nu_c     [L]        shifted line center [cm-1]
    scale_x  [L]        sqrt(ln2)/alpha_D  (x = (nu - nu_c) * scale_x)
    y        [L]        sqrt(ln2) * gamma_L / alpha_D
    amps     [n_out, L] per-line amplitudes, ALL prefactors folded in:
                        amp = S(T) * w * sqrt(ln2/pi)/alpha_D * u
Stage 2 (:func:`accumulate_jnp` / the Pallas kernel in
:mod:`spectrobot_tpu.ops.pallas_opacity`): the hot loop

    out[o, p] = sum_i amps[o, i] * Re w(x_ip, y_i)

i.e. exactly the (spectral-point x line) evaluations of BASELINE.json:2.
Accumulating ``n_out`` spectra at once (absorption + emission weights) costs
one Voigt evaluation, not two — the non-LTE design of ops/planck.py.

Everything per-line broadcasts, so T/p may be per-line arrays: that is how
per-SPECIES Curtis-Godson states are honoured in a single multi-species sum
(scatter the per-species (T, p) to lines via ``species_idx``).

The reference (fedef17/SpectRobot) implements this loop in Fortran/`wofz`
per line (SURVEY.md C5/C6, call stack 4.1 "HOT LOOP" — 99% of runtime).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from spectrobot_tpu.constants import SQRT_LN2, SQRT_LN2_PI
from spectrobot_tpu.ops import voigt as voigt_mod
from spectrobot_tpu.ops.strengths import (
    DeviceLines, doppler_hwhm, line_strength, lorentz_hwhm,
    pressure_shifted_center,
)


class KernelLines(NamedTuple):
    """Flat per-line inputs of the accumulation kernel."""
    nu_c: jnp.ndarray      # [L]
    scale_x: jnp.ndarray   # [L]
    y: jnp.ndarray         # [L]
    amps: jnp.ndarray      # [n_out, L]
    # Optional sub-Lorentzian wing-correction slope per line (ops.chi):
    # chi(|dnu|) = exp(-chi_b max(|dnu| - 3, 0)); None/0 = off (exact 1).
    chi_b: Optional[jnp.ndarray] = None


def line_kernel_inputs(
    lines: DeviceLines,
    T,
    p_pa,
    p_self_pa=0.0,
    amp_weights: Optional[jnp.ndarray] = None,
    chi=None,
) -> KernelLines:
    """Stage-1 prologue: thermodynamic state -> flat kernel inputs.

    T / p_pa / p_self_pa: scalars or [L] per-line arrays (per-species CG
    states scattered onto lines).  amp_weights: [n_out, L] extra per-line
    amplitude weights (column x non-LTE); default a single all-ones row.
    ``chi`` = (ops.chi.ChiProfile, row_mask [n_species] bool): per-line
    sub-Lorentzian wing slopes b(T) for the profile's species (0 = off).
    """
    S = line_strength(lines, T)
    ad = doppler_hwhm(lines, T)
    gl = lorentz_hwhm(lines, T, p_pa, p_self_pa)
    nu_c = pressure_shifted_center(lines, p_pa)
    inv_ad = 1.0 / ad
    base = S * (SQRT_LN2_PI * inv_ad)
    if amp_weights is None:
        amps = base[None, :]
    else:
        amps = amp_weights * base[None, :]
    chi_b = None
    if chi is not None:
        profile, row_mask = chi
        mask = jnp.asarray(row_mask)[lines.species_idx]
        T_line = jnp.broadcast_to(jnp.asarray(T, base.dtype),
                                  lines.nu0.shape)
        chi_b = jnp.where(mask, profile.slope(T_line).astype(base.dtype),
                          0.0)
    return KernelLines(
        nu_c=nu_c,
        scale_x=SQRT_LN2 * inv_ad,
        y=SQRT_LN2 * gl * inv_ad,
        amps=amps,
        chi_b=chi_b,
    )


def accumulate_jnp(
    nu_grid: jnp.ndarray,
    kl: KernelLines,
    *,
    chunk: int = 256,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
) -> jnp.ndarray:
    """Stage-2 hot loop, pure-jnp (XLA) implementation.

    Chunks the line axis with ``lax.scan`` to bound the (chunk x P)
    intermediate.  Returns [n_out, P].
    """
    dt = nu_grid.dtype
    nu_c = kl.nu_c.astype(dt)
    sx = kl.scale_x.astype(dt)
    y = kl.y.astype(dt)
    amps = kl.amps.astype(dt)
    chb = None if kl.chi_b is None else kl.chi_b.astype(dt)
    n_out, L = amps.shape

    chunk = min(chunk, max(L, 1))   # short line lists: no pad waste
    Lp = ((L + chunk - 1) // chunk) * chunk
    pad = Lp - L
    if pad:
        nu_c = jnp.pad(nu_c, (0, pad))
        sx = jnp.pad(sx, (0, pad), constant_values=1.0)
        y = jnp.pad(y, (0, pad), constant_values=1.0)
        amps = jnp.pad(amps, ((0, 0), (0, pad)))
        if chb is not None:
            chb = jnp.pad(chb, (0, pad))
    n_chunks = Lp // chunk
    stacked = (
        nu_c.reshape(n_chunks, chunk),
        sx.reshape(n_chunks, chunk),
        y.reshape(n_chunks, chunk),
        amps.reshape(n_out, n_chunks, chunk).transpose(1, 0, 2),
        (jnp.zeros((n_chunks, chunk), dt) if chb is None
         else chb.reshape(n_chunks, chunk)),
    )

    wofz = (voigt_mod.wofz_humlicek4 if variant == "humlicek4"
            else voigt_mod.wofz_weideman)

    def body(acc, ch):
        nc, s, yy, am, cb = ch
        dnu = nu_grid[None, :] - nc[:, None]              # [chunk, P]
        x = s[:, None] * dnu
        yb = jnp.broadcast_to(yy[:, None], x.shape)
        wr, _ = wofz(x, yb)
        if chb is not None:
            from spectrobot_tpu.ops.chi import CHI_DELTA1
            wr = wr * jnp.exp(-cb[:, None] * jnp.maximum(
                jnp.abs(dnu) - CHI_DELTA1, 0.0))
        if cutoff_cm1 is not None:
            wr = jnp.where(jnp.abs(dnu) <= cutoff_cm1, wr, 0.0)
        # [n_out, P] += [n_out, chunk] @ [chunk, P].
        # HIGHEST precision is REQUIRED: a reduced-precision matmul (TF32 or
        # bf16 passes, ~1e-3 relative) on large cancelling terms corrupts
        # saturated line cores (and catastrophically corrupts Jacobian
        # tangents).
        acc = acc + jnp.einsum("oc,cp->op", am, wr,
                               precision=jax.lax.Precision.HIGHEST)
        return acc, None

    init = jnp.zeros((n_out, nu_grid.shape[0]), dtype=dt)
    out, _ = jax.lax.scan(body, init, stacked)
    return out


# ---------------------------------------------------------------------------
# Analytic custom JVP for the accumulation (SURVEY.md 8.4 hard part 3;
# PAPERS.md:9 "analytic Voigt derivatives")
# ---------------------------------------------------------------------------
#
# The tangent of out[o,p] = sum_i amps[o,i] K(x_ip, y_i), with
# x_ip = sx_i (nu_p - nu_c_i), decomposes over FOUR tangent-independent
# per-pair basis functions
#
#     {K, Kx = dK/dx, xKx = x dK/dx, Ky = dK/dy}
#
# with per-line coefficient vectors:
#
#     d out = [d_amps] K + [-amps sx d_nu_c] Kx + [amps d_sx/sx] xKx
#           + [amps d_y] Ky
#
# Because the basis is tangent-INDEPENDENT, under jax.jacfwd (vmap over
# tangents) it is evaluated once and every Jacobian column is a cheap
# contraction against it — the full analytic Jacobian of the line sum costs
# ~2 extra Voigt-grad passes instead of n_params passes.
#
# CONDITIONING (measured; tests/test_voigt.py, docs/ACCURACY.md): the
# partials (Kx, Ky) must come from the closed-form derivative of the
# Weideman approximant (voigt.wofz_weideman_grad), NOT from the exact
# identity w' = -2 z w + 2i/sqrt(pi).  The identity's real part
# -2(x wr - y wi) cancels to ~8 digits in deep wings (x ~ cutoff/alpha_D ~
# 1e4), and a basis decomposition over {wr, wi, x wr, x wi, x^2 wr} defers
# that cancellation to AFTER the line reduction — in float32 the Jacobian
# of any optically thick layer came out with O(1) relative error (wrong
# sign at saturated cores).  The approximant derivative is per-pair stable
# (~1e-6 rel over the whole upper half plane, worst ~3e-3 at |x| ~ 1e4
# where K ~ 1e-16).


def _basis(nu_grid, nc, s, yy, cb=None, *, variant, cutoff_cm1, dt):
    """Per-(line, point) stable basis (K, Kx, xKx, Ky) for one line chunk.

    Both K and the partials come from the closed-form gradient of the SAME
    approximant the primal uses (round 2): ``humlicek4`` differentiates the
    w4 rationals (:func:`voigt.wofz_humlicek4_grad` — ~2.5x the primal's
    flops and primal-consistent, so analytic Jacobians are the exact
    derivative of the forward), ``weideman`` differentiates the Weideman
    approximant.  Either way the partials are per-pair stable in f32 (see
    the conditioning note above — the exact identity w' = -2zw + 2i/sqrt(pi)
    is NOT usable here).
    """
    dnu = nu_grid[None, :] - nc[:, None]
    x = s[:, None] * dnu
    ybc = jnp.broadcast_to(yy[:, None], x.shape)
    if variant == "humlicek4":
        wr, _, kx, ky = voigt_mod.wofz_humlicek4_grad(x, ybc)
    else:
        wr, _, kx, ky = voigt_mod.wofz_weideman_grad(x, ybc)
    if cb is not None:
        # Sub-Lorentzian wing factor (ops.chi): scales ALL basis rows —
        # chi is treated as CONSTANT in the tangent (frozen-chi
        # convention, ops/chi.py docstring).
        from spectrobot_tpu.ops.chi import CHI_DELTA1
        ch = jnp.exp(-cb[:, None] * jnp.maximum(jnp.abs(dnu) - CHI_DELTA1,
                                                0.0))
        wr = wr * ch
        kx = kx * ch
        ky = ky * ch
    if cutoff_cm1 is not None:
        m = (jnp.abs(dnu) <= cutoff_cm1).astype(dt)
        wr = wr * m
        kx = kx * m
        ky = ky * m
    return wr, kx, x * kx, ky


def _tangent_via_basis(nu_grid, nu_c, sx, y, amps,
                       d_nu_c, d_sx, d_y, d_amps, chb=None,
                       *, chunk, variant, cutoff_cm1, with_primal=False):
    """Tangent of accumulate for one tangent vector (vmap-friendly: the
    basis evaluation does not touch tangent inputs).

    ``with_primal=True`` also accumulates the PRIMAL out = amps @ K in the
    same scan and returns (primal, tangent) — the K basis is already in
    hand, so the custom-JVP rule gets both for one Voigt-grad pass instead
    of a separate primal evaluation (and under jacfwd's tangent vmap the
    primal contraction stays unbatched, evaluated once).
    """
    dt = nu_grid.dtype
    zeros = lambda a: jnp.zeros_like(a)
    d_nu_c = zeros(nu_c) if d_nu_c is None else d_nu_c
    d_sx = zeros(sx) if d_sx is None else d_sx
    d_y = zeros(y) if d_y is None else d_y
    d_amps = zeros(amps) if d_amps is None else d_amps
    n_out, L = amps.shape

    chunk = min(chunk, max(L, 1))   # short line lists: no pad waste
    Lp = ((L + chunk - 1) // chunk) * chunk
    pad = Lp - L
    if pad:
        nu_c = jnp.pad(nu_c, (0, pad))
        sx = jnp.pad(sx, (0, pad), constant_values=1.0)
        y = jnp.pad(y, (0, pad), constant_values=1.0)
        amps = jnp.pad(amps, ((0, 0), (0, pad)))
        d_nu_c = jnp.pad(d_nu_c, (0, pad))
        d_sx = jnp.pad(d_sx, (0, pad))
        d_y = jnp.pad(d_y, (0, pad))
        d_amps = jnp.pad(d_amps, ((0, 0), (0, pad)))
        if chb is not None:
            chb = jnp.pad(chb, (0, pad))
    n_chunks = Lp // chunk
    resh = lambda a: a.reshape(n_chunks, chunk)
    stacked = (resh(nu_c), resh(sx), resh(y),
               amps.reshape(n_out, n_chunks, chunk).transpose(1, 0, 2),
               resh(d_nu_c), resh(d_sx), resh(d_y),
               d_amps.reshape(n_out, n_chunks, chunk).transpose(1, 0, 2),
               (jnp.zeros((n_chunks, chunk), dt) if chb is None
                else resh(chb.astype(dt))))

    def body(carry, ch):
        acc, acc_p = carry
        nc, s, yy, am, dnc, dsx, dy, dam, cb = ch
        K, Kx, xKx, Ky = _basis(nu_grid, nc, s, yy,
                                cb if chb is not None else None,
                                variant=variant,
                                cutoff_cm1=cutoff_cm1, dt=dt)
        B1 = dam                                    # [n_out, c]
        B2 = am * (-s * dnc)[None, :]
        B3 = am * (dsx / s)[None, :]
        B4 = am * dy[None, :]
        # HIGHEST precision is REQUIRED: reduced-precision matmuls corrupt the
        # strongly varying tangent contractions (wrong-sign tangents at
        # saturated line cores).
        hp = dict(precision=jax.lax.Precision.HIGHEST)
        acc = acc + (jnp.einsum("oc,cp->op", B1, K, **hp)
                     + jnp.einsum("oc,cp->op", B2, Kx, **hp)
                     + jnp.einsum("oc,cp->op", B3, xKx, **hp)
                     + jnp.einsum("oc,cp->op", B4, Ky, **hp))
        if with_primal:
            acc_p = acc_p + jnp.einsum("oc,cp->op", am, K, **hp)
        return (acc, acc_p), None

    init = jnp.zeros((n_out, nu_grid.shape[0]), dtype=dt)
    init_p = init if with_primal else jnp.zeros((), dtype=dt)
    (out, out_p), _ = jax.lax.scan(body, (init, init_p), stacked)
    return (out_p, out) if with_primal else out


def _tangent_transpose(nu_grid, nu_c, sx, y, amps, ct, chb=None,
                       *, chunk, variant, cutoff_cm1):
    """Explicit transpose of :func:`_tangent_via_basis` in its tangent
    arguments: cotangent [n_out, P] -> cotangents of (nu_c, sx, y, amps).
    Gives reverse-mode AD the same shared-basis economics as forward mode.
    """
    dt = nu_grid.dtype
    n_out, L = amps.shape
    chunk = min(chunk, max(L, 1))   # short line lists: no pad waste
    Lp = ((L + chunk - 1) // chunk) * chunk
    pad = Lp - L
    if pad:
        nu_c = jnp.pad(nu_c, (0, pad))
        sx = jnp.pad(sx, (0, pad), constant_values=1.0)
        y = jnp.pad(y, (0, pad), constant_values=1.0)
        amps = jnp.pad(amps, ((0, 0), (0, pad)))
        if chb is not None:
            chb = jnp.pad(chb, (0, pad))
    n_chunks = Lp // chunk
    resh = lambda a: a.reshape(n_chunks, chunk)
    stacked = (resh(nu_c), resh(sx), resh(y),
               amps.reshape(n_out, n_chunks, chunk).transpose(1, 0, 2),
               (jnp.zeros((n_chunks, chunk), dt) if chb is None
                else resh(chb.astype(dt))))

    def body(_, ch):
        nc, s, yy, am, cb = ch
        K, Kx, xKx, Ky = _basis(nu_grid, nc, s, yy,
                                cb if chb is not None else None,
                                variant=variant,
                                cutoff_cm1=cutoff_cm1, dt=dt)
        # Abar_k[o, c] = <ct, basis_k> along p (HIGHEST: see tangent note)
        Ab = lambda B: jnp.einsum("op,cp->oc", ct, B,
                                  precision=jax.lax.Precision.HIGHEST)
        AbK, AbKx, AbxKx, AbKy = Ab(K), Ab(Kx), Ab(xKx), Ab(Ky)
        so = lambda M: jnp.sum(M * am, axis=0)       # sum over out-rows
        ct_amps = AbK
        ct_nc = -s * so(AbKx)
        ct_sx = so(AbxKx) / s
        ct_y = so(AbKy)
        return None, (ct_nc, ct_sx, ct_y, ct_amps)

    _, (ct_nc, ct_sx, ct_y, ct_amps) = jax.lax.scan(body, None, stacked)
    unr = lambda a: a.reshape(Lp)[:L]
    ct_amps = ct_amps.transpose(1, 0, 2).reshape(n_out, Lp)[:, :L]
    return unr(ct_nc), unr(ct_sx), unr(ct_y), ct_amps


def accumulate_pallas_jit(nu_grid, kl: KernelLines, *,
                          tile_p: Optional[int] = None,
                          block_l: Optional[int] = None,
                          cutoff_cm1: Optional[float] = 25.0,
                          interpret: bool = False,
                          windows=None) -> jnp.ndarray:
    """Pallas stage-2 accumulation callable INSIDE jit (the batch kernel
    with B = 1): by default every line block is visited for every tile,
    with the exact in-kernel |dnu| <= cutoff mask and block-level region
    dispatch doing the skipping work.  No host-side data needed, so this
    composes with jit/vmap — the kernel engine for the DIFFERENTIABLE
    paths.  ``windows`` = (starts, counts, max_blocks) from
    :func:`ops.pallas_opacity.static_windows` (host-known grid/centers —
    the build_forward case) bakes REAL ragged windows in as compile-time
    constants, skipping provably-out-of-cutoff blocks entirely."""
    from spectrobot_tpu.ops.pallas_opacity import (
        DEFAULT_BLOCK_L, DEFAULT_TILE_P, accumulate_pallas_batch_jit)

    out = accumulate_pallas_batch_jit(
        nu_grid, kl.nu_c[None], kl.scale_x[None], kl.y[None],
        kl.amps[None],
        tile_p=DEFAULT_TILE_P if tile_p is None else tile_p,
        block_l=DEFAULT_BLOCK_L if block_l is None else block_l,
        cutoff_cm1=cutoff_cm1, interpret=interpret, windows=windows,
        chi_b=None if kl.chi_b is None else kl.chi_b[None])
    return out[0]


def _make_tangent_pallas(*, cutoff_cm1, interpret, tile_p=None, block_l=None,
                         max_blocks=None, has_chi=False):
    """Fused Pallas tangent of the accumulation (round-1 review item 4).

    Returns tangent(nu, nu_c, sx, y, amps, d_nu_c, d_sx, d_y, d_amps,
    wst, wct) -> [n_out, P], built on the in-kernel basis contraction
    (:func:`spectrobot_tpu.ops.pallas_opacity.basis_contract_pallas_jit`).
    Ragged kernel windows arrive as the trailing (wst, wct) ARGUMENTS with
    the static ``max_blocks`` in closure — arguments, not closure, because
    per-shard window tables are TRACED inside shard_map bodies and
    custom_vmap stages its functions (closed-over tracers would leak);
    with ``max_blocks=None`` the dummies are ignored (all-blocks).

    The economics problem this solves: under ``jax.jacfwd`` the tangent
    function is vmapped over every Jacobian column, and a naive pallas
    tangent would re-evaluate the (expensive, tangent-independent) Voigt
    basis per column.  Both vmap levels that occur in practice are
    intercepted with ``jax.custom_batching.custom_vmap``:

      * structural (ray x layer) vmaps batch ALL line arguments — routed to
        the explicit-batch kernel (one pallas grid dim per state);
      * the jacfwd tangent vmap batches ONLY the d_* arguments — FOLDED into
        the kernel's output-row axis (R = n_tangents x n_out), so the basis
        is evaluated once per (state, tile, block) for the whole Jacobian
        and each column costs four contraction rows.
    """
    from jax.custom_batching import custom_vmap

    from spectrobot_tpu.ops.pallas_opacity import (
        DEFAULT_BLOCK_L, DEFAULT_TILE_P, basis_contract_pallas_batch_jit,
        basis_contract_pallas_jit)

    kw = dict(tile_p=DEFAULT_TILE_P if tile_p is None else tile_p,
              block_l=DEFAULT_BLOCK_L if block_l is None else block_l,
              cutoff_cm1=cutoff_cm1, interpret=interpret)

    def win(wst, wct):
        return None if max_blocks is None else (wst, wct, max_blocks)

    def coeffs(sx, amps, d_nu_c, d_sx, d_y, d_amps):
        """Basis coefficient rows; broadcasts over any leading batch axes
        (amps [..., n_out, L], per-line args [..., L])."""
        C1 = d_amps
        C2 = amps * (-sx * d_nu_c)[..., None, :]
        C3 = amps * (d_sx / sx)[..., None, :]
        C4 = amps * d_y[..., None, :]
        return C1, C2, C3, C4

    # The PRIMAL rides the same kernel pass as extra rows contracting only
    # against K (coefficients [amps, 0, 0, 0]) — one basis evaluation yields
    # primal + every tangent.  Both functions return (primal, tangent).

    def zeros_like_rows(am):
        return jnp.zeros_like(am)

    chi_kw = lambda cb: ({"chi_b": cb} if has_chi else {})

    # ---- level 1: explicit state batch [B, ...] ----
    @custom_vmap
    def tanB(nu, nc, sx, y, cb, am, dnc, dsx, dy, dam, wst, wct):
        C1, C2, C3, C4 = coeffs(sx, am, dnc, dsx, dy, dam)
        z = zeros_like_rows(am)
        cat = lambda a, b: jnp.concatenate([a, b], axis=1)
        # Sufficient active mask: C2..C4 are amps-scaled, so amps | d_amps
        # covers every coefficient row (dead limb layers skip in-kernel).
        act = (jnp.any(am != 0, axis=(1, 2))
               | jnp.any(dam != 0, axis=(1, 2))).astype(jnp.int32)
        out = basis_contract_pallas_batch_jit(
            nu, nc, sx, y, cat(am, C1), cat(z, C2), cat(z, C3), cat(z, C4),
            windows=win(wst, wct), active=act, **chi_kw(cb), **kw)
        n_out = am.shape[1]
        return out[:, :n_out], out[:, n_out:]

    @tanB.def_vmap
    def tanB_rule(axis_size, in_batched, nu, nc, sx, y, cb, am, dnc, dsx,
                  dy, dam, wst, wct):
        nub, ncb, sxb, yb, cbb, amb, d1b, d2b, d3b, d4b, wsb, wcb = in_batched
        assert not (wsb or wcb), "window tables must not be batched"
        if nub:  # grid batched — no fused form; correctness fallback
            args = [jnp.broadcast_to(a, (axis_size,) + a.shape) if not b else a
                    for a, b in zip((nu, nc, sx, y, cb, am, dnc, dsx, dy, dam),
                                    in_batched[:10])]
            return jax.lax.map(lambda t: tanB(*t, wst, wct),
                               tuple(args)), (True, True)
        if not (ncb or sxb or yb or cbb or amb):
            # Tangent-only batch: fold n_t into the kernel row axis; the
            # primal rows are shared (unbatched output).
            n_t = axis_size
            B, n_out, L = am.shape
            C1, C2, C3, C4 = coeffs(sx, am, dnc, dsx, dy, dam)
            # [n_t, B, n_out, L] -> [B, n_t * n_out, L]
            fold = lambda C: jnp.moveaxis(C, 0, 1).reshape(B, n_t * n_out, L)
            z = jnp.zeros_like(am)
            cat = lambda a, b: jnp.concatenate([a, b], axis=1)
            act = (jnp.any(am != 0, axis=(1, 2))
                   | jnp.any(dam != 0, axis=(0, 2, 3))).astype(jnp.int32)
            out = basis_contract_pallas_batch_jit(
                nu, nc, sx, y, cat(am, fold(C1)), cat(z, fold(C2)),
                cat(z, fold(C3)), cat(z, fold(C4)), windows=win(wst, wct),
                active=act, **chi_kw(cb), **kw)
            primal = out[:, :n_out]
            tangent = jnp.moveaxis(
                out[:, n_out:].reshape(B, n_t, n_out, -1), 1, 0)
            return (primal, tangent), (False, True)
        # Structural batch (or mixed): broadcast and flatten into B.
        bcast = lambda a, b: a if b else jnp.broadcast_to(
            a, (axis_size,) + a.shape)
        nc, sx, y, cb, am, dnc, dsx, dy, dam = (
            bcast(a, b) for a, b in zip(
                (nc, sx, y, cb, am, dnc, dsx, dy, dam),
                (ncb, sxb, yb, cbb, amb, d1b, d2b, d3b, d4b)))
        B2, B = nc.shape[0], nc.shape[1]
        flat = lambda a: a.reshape((B2 * B,) + a.shape[2:])
        p, t = tanB(nu, flat(nc), flat(sx), flat(y), flat(cb), flat(am),
                    flat(dnc), flat(dsx), flat(dy), flat(dam), wst, wct)
        unflat = lambda a: a.reshape((B2, B) + a.shape[1:])
        return (unflat(p), unflat(t)), (True, True)

    # ---- level 0: single state ----
    @custom_vmap
    def tan0(nu, nc, sx, y, cb, am, dnc, dsx, dy, dam, wst, wct):
        C1, C2, C3, C4 = coeffs(sx, am, dnc, dsx, dy, dam)
        z = zeros_like_rows(am)
        cat = lambda a, b: jnp.concatenate([a, b], axis=0)
        out = basis_contract_pallas_jit(
            nu, nc, sx, y, cat(am, C1), cat(z, C2), cat(z, C3), cat(z, C4),
            windows=win(wst, wct), **chi_kw(cb), **kw)
        n_out = am.shape[0]
        return out[:n_out], out[n_out:]

    @tan0.def_vmap
    def tan0_rule(axis_size, in_batched, nu, nc, sx, y, cb, am, dnc, dsx,
                  dy, dam, wst, wct):
        nub, ncb, sxb, yb, cbb, amb, d1b, d2b, d3b, d4b, wsb, wcb = in_batched
        assert not (wsb or wcb), "window tables must not be batched"
        if nub:  # grid batched — correctness fallback
            args = [jnp.broadcast_to(a, (axis_size,) + a.shape) if not b else a
                    for a, b in zip((nu, nc, sx, y, cb, am, dnc, dsx, dy, dam),
                                    in_batched[:10])]
            return jax.lax.map(lambda t: tan0(*t, wst, wct),
                               tuple(args)), (True, True)
        if not (ncb or sxb or yb or cbb or amb):
            # Tangent-only batch (jacfwd over a single state): fold into
            # rows; primal rows shared (unbatched output).
            n_t = axis_size
            n_out, L = am.shape
            C1, C2, C3, C4 = coeffs(sx, am, dnc, dsx, dy, dam)
            fold = lambda C: C.reshape(n_t * n_out, L)
            z = jnp.zeros_like(am)
            cat = lambda a, b: jnp.concatenate([a, b], axis=0)
            out = basis_contract_pallas_jit(
                nu, nc, sx, y, cat(am, fold(C1)), cat(z, fold(C2)),
                cat(z, fold(C3)), cat(z, fold(C4)), windows=win(wst, wct),
                **chi_kw(cb), **kw)
            return (out[:n_out], out[n_out:].reshape(n_t, n_out, -1)), \
                (False, True)
        # Structural batch: promote to the explicit-batch op.
        bcast = lambda a, b: a if b else jnp.broadcast_to(
            a, (axis_size,) + a.shape)
        nc, sx, y, cb, am, dnc, dsx, dy, dam = (
            bcast(a, b) for a, b in zip(
                (nc, sx, y, cb, am, dnc, dsx, dy, dam),
                (ncb, sxb, yb, cbb, amb, d1b, d2b, d3b, d4b)))
        return tanB(nu, nc, sx, y, cb, am, dnc, dsx, dy, dam, wst, wct), \
            (True, True)

    return tan0


def _make_primal_pallas(*, cutoff_cm1, interpret, max_blocks=None,
                        tile_p=None, block_l=None, has_chi=False):
    """Primal-only Pallas accumulation with structural-batch routing.

    Mirrors :func:`_make_tangent_pallas`'s two custom_vmap levels for the
    UNDIFFERENTIATED forward: per-(ray, layer) vmaps route to the explicit
    batch kernel (:func:`spectrobot_tpu.ops.pallas_opacity.
    accumulate_pallas_batch_jit`) instead of pallas's generic vmap rule, so
    the per-state active mask skips dead limb layers (~45 % of a limb
    scan's (ray x layer) rectangle is below-tangent, zero-column states)
    and extra vmap levels flatten into one kernel batch axis.  Signature:
    f(nu, nu_c, sx, y, amps, wst, wct) -> [n_out, P]."""
    from jax.custom_batching import custom_vmap

    from spectrobot_tpu.ops.pallas_opacity import (
        DEFAULT_BLOCK_L, DEFAULT_TILE_P, accumulate_pallas_batch_jit)

    kw = dict(tile_p=DEFAULT_TILE_P if tile_p is None else tile_p,
              block_l=DEFAULT_BLOCK_L if block_l is None else block_l,
              cutoff_cm1=cutoff_cm1, interpret=interpret)

    def win(wst, wct):
        return None if max_blocks is None else (wst, wct, max_blocks)

    chi_kw = lambda cb: ({"chi_b": cb} if has_chi else {})

    @custom_vmap
    def accB(nu, nc, sx, y, cb, am, wst, wct):
        return accumulate_pallas_batch_jit(nu, nc, sx, y, am,
                                           windows=win(wst, wct),
                                           **chi_kw(cb), **kw)

    @accB.def_vmap
    def accB_rule(axis_size, in_batched, nu, nc, sx, y, cb, am, wst, wct):
        nub, ncb, sxb, yb, cbb, amb, wsb, wcb = in_batched
        assert not (wsb or wcb), "window tables must not be batched"
        if nub:  # grid batched — correctness fallback
            args = [jnp.broadcast_to(a, (axis_size,) + a.shape) if not b else a
                    for a, b in zip((nu, nc, sx, y, cb, am), in_batched[:6])]
            return jax.lax.map(lambda t: accB(*t, wst, wct), tuple(args)), True
        bcast = lambda a, b: a if b else jnp.broadcast_to(
            a, (axis_size,) + a.shape)
        nc, sx, y, cb, am = (bcast(a, b) for a, b in
                             zip((nc, sx, y, cb, am),
                                 (ncb, sxb, yb, cbb, amb)))
        B2, B = nc.shape[0], nc.shape[1]
        flat = lambda a: a.reshape((B2 * B,) + a.shape[2:])
        out = accB(nu, flat(nc), flat(sx), flat(y), flat(cb), flat(am),
                   wst, wct)
        return out.reshape((B2, B) + out.shape[1:]), True

    @custom_vmap
    def acc0(nu, nc, sx, y, cb, am, wst, wct):
        return accumulate_pallas_jit(
            nu, KernelLines(nc, sx, y, am, cb if has_chi else None),
            windows=win(wst, wct), **kw)

    @acc0.def_vmap
    def acc0_rule(axis_size, in_batched, nu, nc, sx, y, cb, am, wst, wct):
        nub, ncb, sxb, yb, cbb, amb, wsb, wcb = in_batched
        assert not (wsb or wcb), "window tables must not be batched"
        if nub:  # grid batched — correctness fallback
            args = [jnp.broadcast_to(a, (axis_size,) + a.shape) if not b else a
                    for a, b in zip((nu, nc, sx, y, cb, am), in_batched[:6])]
            return jax.lax.map(lambda t: acc0(*t, wst, wct), tuple(args)), True
        bcast = lambda a, b: a if b else jnp.broadcast_to(
            a, (axis_size,) + a.shape)
        nc, sx, y, cb, am = (bcast(a, b) for a, b in
                             zip((nc, sx, y, cb, am),
                                 (ncb, sxb, yb, cbb, amb)))
        return accB(nu, nc, sx, y, cb, am, wst, wct), True

    return acc0


def default_engine() -> str:
    """The opacity engine for the default device: 'pallas' (the Triton
    kernels of ops.pallas_opacity) on a GPU, 'jnp' (XLA; the reference)
    on any other backend."""
    return "pallas" if jax.devices()[0].platform == "gpu" else "jnp"


def make_accumulate_op(*, chunk: int = 256, variant: str = "humlicek4",
                       cutoff_cm1: Optional[float] = 25.0,
                       engine: str = "jnp", interpret: bool = False,
                       mode: str = "fwd", windows=None,
                       has_chi: bool = False):
    """Build accumulate(nu_grid, nu_c, scale_x, y, amps) -> [n_out, P] with
    ANALYTIC derivatives.  nu_grid is non-differentiated (static instrument
    grid; its tangent/cotangent is ignored/zero).  engine: 'jnp' (XLA, any
    backend/dtype) or 'pallas' (GPU kernel primal via
    :func:`accumulate_pallas_jit`, float32, jit- and vmap-composable;
    mode='fwd' tangents route to the FUSED in-kernel basis contraction —
    :func:`_make_tangent_pallas` — which evaluates the Voigt basis once per
    Jacobian and folds every column into the kernel's row axis; the 'rev'
    transpose stays on the jnp basis path).

    mode='fwd' (default): ``jax.custom_jvp`` — jax.jacfwd / jax.jvp get the
    shared-basis analytic tangent (one Voigt pass for the whole Jacobian).
    Reverse-mode through the 'fwd' op is unsupported (the chunked tangent
    scan does not auto-transpose, and neither ``linear_call`` nor
    ``custom_transpose`` has a batching rule in current JAX).

    mode='rev': ``jax.custom_vjp`` — grad / jacrev / jax.vjp get the
    ANALYTIC transpose: one Voigt basis pass + six contractions per
    cotangent, with NO stored linearisation of the line sum (the backward
    recomputes wofz from the saved flat inputs — O(L + n_out*P) residual
    memory instead of AD's O(chunk*P) per-scan-step stash).  The backward
    is the jnp basis scan (:func:`_tangent_transpose`) for either engine;
    with engine='pallas' only the primal runs in the kernel (reverse mode
    is off the CLI's path, which uses jacfwd).  custom_vjp batches under
    vmap, so this
    composes with the per-layer vmaps.  Forward-mode through the 'rev' op
    is unsupported (JAX's custom_vjp forbids jvp); pick the mode matching
    the caller's AD direction.
    """
    kw = dict(chunk=chunk, variant=variant, cutoff_cm1=cutoff_cm1)
    if engine == "pallas" and variant != "humlicek4":
        raise ValueError(
            "engine='pallas' evaluates humlicek4 only (the kernel's region "
            "dispatch); use engine='jnp' for variant="
            f"{variant!r} so primal and tangent share one evaluator")
    if mode not in ("fwd", "rev"):
        raise ValueError(f"mode must be 'fwd' or 'rev', got {mode!r}")

    # Ragged kernel windows: (starts, counts) flow as ARGUMENTS through the
    # custom_jvp/custom_vmap boundaries (those stage their functions, so
    # closed-over TRACED tables — the per-shard shard_map case — would
    # leak); only the static max_blocks lives in closure.
    mb = None if windows is None else int(windows[2])
    if windows is None:
        _wst = _wct = jnp.zeros((1,), jnp.int32)   # ignored dummies
    else:
        _wst = jnp.asarray(windows[0], jnp.int32)
        _wct = jnp.asarray(windows[1], jnp.int32)

    primal_pallas = (_make_primal_pallas(
        cutoff_cm1=cutoff_cm1, interpret=interpret, max_blocks=mb,
        has_chi=has_chi)
        if engine == "pallas" else None)

    def _primal(nu_grid, nu_c, sx, y, chb, amps, wst, wct):
        if engine == "pallas":
            return primal_pallas(nu_grid, nu_c, sx, y, chb, amps, wst,
                                 wct).astype(jnp.result_type(nu_grid))
        return accumulate_jnp(
            nu_grid,
            KernelLines(nu_c, sx, y, amps, chb if has_chi else None), **kw)

    if mode == "rev":
        if windows is not None and isinstance(windows[0], jax.core.Tracer):
            raise ValueError(
                "mode='rev' needs CONCRETE windows (the custom_vjp backward "
                "closes over them); pass windows=None inside shard_map "
                "bodies or run the rev op outside the mesh")
        @jax.custom_vjp
        def acc(nu_grid, nu_c, sx, y, chb, amps):
            return _primal(nu_grid, nu_c, sx, y, chb, amps, _wst, _wct)

        def acc_fwd(nu_grid, nu_c, sx, y, chb, amps):
            return (_primal(nu_grid, nu_c, sx, y, chb, amps, _wst, _wct),
                    (nu_grid, nu_c, sx, y, chb, amps))

        def acc_bwd(res, ct):
            # Frozen-chi convention in reverse mode too (ops/chi.py): chi
            # scales all four basis projections; its own cotangent is 0.
            nu_grid, nu_c, sx, y, chb, amps = res
            ct_nc, ct_sx, ct_y, ct_amps = _tangent_transpose(
                nu_grid, nu_c, sx, y, amps, ct, chb if has_chi else None,
                **kw)
            return (jnp.zeros_like(nu_grid), ct_nc, ct_sx, ct_y,
                    jnp.zeros_like(chb), ct_amps)

        acc.defvjp(acc_fwd, acc_bwd)

        def acc_pub_rev(nu_grid, nu_c, sx, y, amps, chb=None):
            if chb is None:
                chb = jnp.zeros_like(y)
            return acc(nu_grid, nu_c, sx, y, chb, amps)

        return acc_pub_rev

    tangent_pallas = (_make_tangent_pallas(
        cutoff_cm1=cutoff_cm1, interpret=interpret, max_blocks=mb,
        has_chi=has_chi)
        if engine == "pallas" else None)

    @jax.custom_jvp
    def acc(nu_grid, nu_c, sx, y, chb, amps, wst, wct):
        return _primal(nu_grid, nu_c, sx, y, chb, amps, wst, wct)

    @acc.defjvp
    def acc_jvp(primals, tangents):
        # The primal comes out of the SAME basis pass as the tangent
        # (out = amps @ K with K already in hand) — one Voigt-grad
        # evaluation yields primal + every Jacobian column.  The chi
        # tangent is IGNORED (frozen-chi convention, ops/chi.py).
        nu_grid, nu_c, sx, y, chb, amps, wst, wct = primals
        _, d_nu_c, d_sx, d_y, _d_chb, d_amps = tangents[:6]
        if tangent_pallas is not None:
            zero = lambda p, d: jnp.zeros_like(p) if d is None else d
            primal_out, tangent_out = tangent_pallas(
                nu_grid, nu_c, sx, y, chb, amps, zero(nu_c, d_nu_c),
                zero(sx, d_sx), zero(y, d_y), zero(amps, d_amps),
                wst, wct)
            dt = jnp.result_type(nu_grid)
            return primal_out.astype(dt), tangent_out.astype(dt)
        primal_out, tangent_out = _tangent_via_basis(
            nu_grid, nu_c, sx, y, amps, d_nu_c, d_sx, d_y, d_amps,
            chb if has_chi else None, with_primal=True, **kw)
        return primal_out, tangent_out

    def acc_pub(nu_grid, nu_c, sx, y, amps, chb=None):
        # Plain inline wrapper (no staging): binds the window tables in the
        # SAME trace that created them.
        if chb is None:
            chb = jnp.zeros_like(y)
        return acc(nu_grid, nu_c, sx, y, chb, amps, _wst, _wct)

    return acc_pub


def _ad_mode(analytic_jvp) -> Optional[str]:
    """Normalise the public ``analytic_jvp`` switch: True/'fwd' -> analytic
    custom JVP (forward-mode AD), 'rev' -> analytic custom VJP (reverse-mode
    AD), False/None -> plain-AD accumulation (either direction, slower)."""
    if analytic_jvp is True or analytic_jvp == "fwd":
        return "fwd"
    if analytic_jvp == "rev":
        return "rev"
    if analytic_jvp in (False, None):
        return None
    raise ValueError(
        f"analytic_jvp must be True/'fwd', 'rev', or False; got "
        f"{analytic_jvp!r}")


def cross_sections(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    T,
    p_pa,
    p_self_pa=0.0,
    w_abs: Optional[jnp.ndarray] = None,
    w_em: Optional[jnp.ndarray] = None,
    *,
    chunk: int = 256,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    analytic_jvp: bool = True,
    nu_off: Optional[jnp.ndarray] = None,
    chi=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Absorption & emission cross sections [cm^2/molec] for one homogeneous
    state — thin wrapper over the two-stage API (kept as the stable public
    interface; SURVEY.md C6).  ``chi`` = (ops.chi.ChiProfile, row_mask):
    the sub-Lorentzian wing correction (ops/chi.py).

    analytic_jvp=True/'fwd' (default) routes through the shared-basis
    analytic JVP op (forward-mode AD: jacfwd/jvp); 'rev' through the
    analytic custom VJP (reverse-mode AD: grad/jacrev with the explicit
    transpose); False uses plain-AD accumulation (either direction).
    ``nu_off``: grid in offset coordinates staged from float64 (see
    DeviceLines docstring); default derives it from ``nu_grid`` (exact only
    for float64 grids).
    """
    L = lines.n_lines
    ones = jnp.ones((L,), dtype=jnp.result_type(lines.sw))
    wa = ones if w_abs is None else w_abs
    we = ones if w_em is None else w_em
    kl = line_kernel_inputs(lines, T, p_pa, p_self_pa,
                            amp_weights=jnp.stack([wa, we]), chi=chi)
    # Offset coordinates for the dnu computation (see DeviceLines docstring).
    if nu_off is None:
        nu_off = nu_grid - lines.nu_ref.astype(nu_grid.dtype)
    mode = _ad_mode(analytic_jvp)
    if mode is not None:
        op = make_accumulate_op(chunk=chunk, variant=variant,
                                cutoff_cm1=cutoff_cm1, mode=mode,
                                has_chi=kl.chi_b is not None)
        if kl.chi_b is None:
            out = op(nu_off, kl.nu_c, kl.scale_x, kl.y, kl.amps)
        else:
            out = op(nu_off, kl.nu_c, kl.scale_x, kl.y, kl.amps, kl.chi_b)
    else:
        out = accumulate_jnp(nu_off, kl, chunk=chunk, variant=variant,
                             cutoff_cm1=cutoff_cm1)
    return out[0], out[1]


def cross_sections_batch(
    nu_grid, lines, T_lay, p_lay, p_self_lay, w_abs_lay=None, w_em_lay=None,
    **kw,
):
    """Per-layer cross sections: T_lay/p_lay/p_self_lay are [n_lay];
    weights [n_lay, L] or None.  Returns (sigma_abs, sigma_em) [n_lay, P]."""
    if w_abs_lay is None:
        f = jax.vmap(lambda T, p, ps: cross_sections(
            nu_grid, lines, T, p, ps, None, None, **kw))
        return f(T_lay, p_lay, p_self_lay)
    f = jax.vmap(lambda T, p, ps, wa, we: cross_sections(
        nu_grid, lines, T, p, ps, wa, we, **kw))
    return f(T_lay, p_lay, p_self_lay, w_abs_lay, w_em_lay)
