"""Fused Voigt line-shape + opacity accumulation kernels for NVIDIA GPUs,
written in Pallas for the Triton backend (components C5+C6; SURVEY.md 8.3 —
the native-performance tier replacing the reference's Fortran inner loop).

Contract (same as :func:`spectrobot_tpu.ops.opacity.accumulate_jnp`):

    out[b, r, p] = sum_i  C1[b,r,i] K_bip + C2[b,r,i] Kx_bip
                        + C3[b,r,i] xKx_bip + C4[b,r,i] Ky_bip,
    K = Re w(x, y),  x_bip = (nu_grid[p] - nu_c[b,i]) * scale_x[b,i]

The primal line sum is the special case with one coefficient set (the line
amplitudes) against K alone; the fused analytic-Jacobian basis uses all
four (ops/opacity.py "analytic custom JVP" notes).

Kernel layout:
* Grid (state b, nu-tile i); both axes are parallel.  Each program owns
  one [TILE_P]-point tile of one state and loops (``lax.fori_loop``) over
  that tile's own window of line blocks, loading ``starts[i]``,
  ``counts[i]`` and ``active[b]`` itself.  The accumulator stays in
  registers; nothing is carried between programs.
* Line windowing: lines arrive sorted by nu0 (C1), so each BLOCK_L-line
  block spans a contiguous wavenumber interval; the host computes, per nu
  tile, the [start, start + count) range of blocks within the wing cutoff
  (:func:`static_windows`) and the loop visits only those.  Out-of-window
  points inside visited blocks are masked elementwise, so windowed and
  all-blocks evaluations agree bit for bit.
* Tier dispatch: per (tile, block) the conservative bound
  s_min = gap * min(scale_x) + min(y) selects, with nested ``lax.cond``, the
  cheapest Humlicek formula valid for EVERY pair of the block (the far
  region-1 rational covers most pairs of a windowed sum).  Each tier is
  exactly what the pointwise w4 selects there, so dispatch is exact.
* Reduction over lines: up to ``_SUM_ROWS`` output rows contract by
  multiply-and-sum; more rows (the fused Jacobian folds every tangent
  column into the row axis) contract in 16-row chunks with ``dot_general``
  pinned to ``Precision.HIGHEST`` — IEEE float32 on the CUDA cores.  The
  default precision would run in TF32 (~1e-3 relative), which flips
  Jacobian signs at saturated line cores (tests/test_matmul_precision.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from spectrobot_tpu.constants import INV_SQRT_PI
from spectrobot_tpu.ops import cpx
from spectrobot_tpu.ops.chi import CHI_DELTA1
from spectrobot_tpu.ops.opacity import KernelLines
from spectrobot_tpu.ops.voigt import wofz_humlicek4, wofz_humlicek4_grad


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Kernel geometry (powers of two, as Triton requires).  Window tables and
# kernels MUST agree on TILE_P/BLOCK_L: every default below routes through
# these two constants, and the window helpers take the same arguments as
# the kernels.  Chosen by benchmarks/kernel_sweep.py on an H100 (PERF.md
# "Kernel decisions"): small tiles keep the gradient tiers' temporaries in
# registers (64x32 spilled: 2x slower; 128x32 10x), and two pipeline
# stages overlap the next block's loads with the current block's math.
DEFAULT_TILE_P = 32
DEFAULT_BLOCK_L = 16
_NUM_WARPS = 4
_NUM_STAGES = 2
# Output rows contracted by multiply-and-sum (the primal's absorption and
# emission rows); larger row counts go through 16-row dot chunks (Triton's
# dot needs every dimension >= 16).
_SUM_ROWS = 4
_ROW_CHUNK = 16

# Block-level region-IV elision threshold: region IV needs
# y < 0.195|x| - 0.176 with |x| + y < 5.5, so its y is < 0.8965; a block
# whose min(y) >= 0.9 (margin for f32 slop) provably has no region-IV
# pair and dispatches to the transcendental-free 3-region evaluator
# (bit-identical there — see ops.voigt.wofz_humlicek4).
_Y4_MIN = 0.9


def _wr_region1(x, y):
    """Humlicek region-1 real part (valid for s = |x|+y >= 15): ~12 flops,
    no transcendentals.  Re w = c * y (0.5 + x^2 + y^2) / |0.5 + t^2|^2.
    EXACTLY the formula w4 selects pointwise in region 1, so block-level
    dispatch keeps bit parity with the full evaluator."""
    y2 = y * y
    a = 0.5 + y2 - x * x
    b = 2.0 * x * y
    return INV_SQRT_PI * y * (0.5 + y2 + x * x) / (a * a + b * b)


def _wr_region2(x, y):
    """Humlicek region-2 real part (valid for s >= 5.5): the degree-2
    rational in u = t^2, expanded over real pairs (~45 flops, no
    transcendentals).  w = t (1.410474 + u c) / (0.75 + u (3 + u))."""
    # t = y - i x ; u = t^2
    ur = y * y - x * x
    ui = -2.0 * x * y
    # numerator n = t * (1.410474 + c*u),  c = 1/sqrt(pi)
    ar = 1.410474 + INV_SQRT_PI * ur
    ai = INV_SQRT_PI * ui
    nr = y * ar + x * ai
    ni = y * ai - x * ar
    # denominator d = 0.75 + u (3 + u)
    br = 3.0 + ur
    dr = 0.75 + (ur * br - ui * ui)
    di = ur * ui + ui * br
    inv = 1.0 / (dr * dr + di * di)
    return (nr * dr + ni * di) * inv


def _dispatch(s_min, y_min, far, mid, near3, near):
    """Run the tier selected by the block bounds: far (region 1 only), mid
    (regions 1/2), near3 (no region IV) or near (full w4).  Nested boolean
    conds: each lowers to one uniform branch for the whole program."""
    cond = jax.lax.cond
    return cond(s_min >= 15.0, far, lambda: cond(
        s_min >= 5.5, mid, lambda: cond(y_min >= _Y4_MIN, near3, near)))


def _wr_tile(x, y, s_min, y_min):
    """Faddeeva real part for one (TILE_P x BLOCK_L) tile with block-level
    region dispatch on the conservative bound s >= s_min:

      s_min >= 15  : every pair is in Humlicek region 1 (12 flops)
      s_min >= 5.5 : regions 1/2 only — pointwise select between the two
                     rationals (~60 flops, still transcendental-free)
      y_min >= 0.9 : regions 1/2/3 — region IV provably empty, so the
                     transcendental cexp + degree-6/7 rationals are skipped
      otherwise    : full branchless w4 (all four regions + complex exp)

    Each branch is EXACTLY what pointwise w4 selects in its regime, so
    dispatch preserves bit parity."""
    def far():
        return _wr_region1(x, y)

    def mid():
        s = jnp.abs(x) + y
        return jnp.where(s >= 15.0, _wr_region1(x, y), _wr_region2(x, y))

    def near3():
        wr, _ = wofz_humlicek4(x, y, with_region4=False)
        return wr

    def near():
        wr, _ = wofz_humlicek4(x, y)
        return wr

    return _dispatch(s_min, y_min, far, mid, near3, near)


def _wrg_region1(x, y):
    """Humlicek region-1 (K, dK/dx, dK/dy) — primal identical to
    :func:`_wr_region1`; the derivative is the closed form of THAT formula:
    with t = y - ix, u = t^2, f' = c (0.5 - u)/(0.5 + u)^2, dK/dx = Im f',
    dK/dy = Re f'.  Divisions staged through cinv so the largest
    intermediate is |0.5+u|^2 ~ x^4 (f32-safe at wing extremes)."""
    ur = y * y - x * x
    ui = -2.0 * x * y
    den = (0.5 + ur, ui)
    inv = cpx.cinv(den)
    K = INV_SQRT_PI * y * (0.5 + y * y + x * x) / (
        den[0] * den[0] + den[1] * den[1])
    g = cpx.cmul(cpx.cscale(INV_SQRT_PI, (0.5 - ur, -ui)),
                 cpx.cmul(inv, inv))
    return K, g[1], g[0]


def _wrg_region2(x, y):
    """Humlicek region-2 (K, dK/dx, dK/dy): primal identical to
    :func:`_wr_region2`; derivative f' = Nd(u)/D(u)^2 with the real-coeff
    cubic Nd(u) = -c u^3 + 3(c-a) u^2 + (2.25c - 3a) u + 0.75a
    (a = 1.410474, c = 1/sqrt(pi)), staged through cinv."""
    a = 1.410474
    c = INV_SQRT_PI
    ur = y * y - x * x
    ui = -2.0 * x * y
    u = (ur, ui)
    den = cpx.cadd_re(0.75, cpx.cmul(u, cpx.cadd_re(3.0, u)))
    inv = cpx.cinv(den)
    num = cpx.cmul((y, -x), cpx.cadd_re(a, cpx.cscale(c, u)))
    w = cpx.cmul(num, inv)
    nd = cpx.cpolyval_real_coeffs(
        (-c, 3.0 * (c - a), 2.25 * c - 3.0 * a, 0.75 * a), u)
    g = cpx.cmul(cpx.cmul(nd, inv), inv)
    return w[0], g[1], g[0]


def _basis_tile(x, y, s_min, y_min):
    """(K, Kx, xKx, Ky) for one tile with the same 4-tier block-level region
    dispatch as :func:`_wr_tile` — each tier computes the closed-form
    derivative OF the formula the primal uses there, so the analytic
    Jacobian is the exact derivative of the kernel forward."""
    def far():
        K, kx, ky = _wrg_region1(x, y)
        return K, kx, x * kx, ky

    def mid():
        s = jnp.abs(x) + y
        K1, kx1, ky1 = _wrg_region1(x, y)
        K2, kx2, ky2 = _wrg_region2(x, y)
        m = s >= 15.0
        K = jnp.where(m, K1, K2)
        kx = jnp.where(m, kx1, kx2)
        ky = jnp.where(m, ky1, ky2)
        return K, kx, x * kx, ky

    def near3():
        K, _, kx, ky = wofz_humlicek4_grad(x, y, with_region4=False)
        return K, kx, x * kx, ky

    def near():
        K, _, kx, ky = wofz_humlicek4_grad(x, y)
        return K, kx, x * kx, ky

    return _dispatch(s_min, y_min, far, mid, near3, near)


def _line_sum_kernel(starts_ref, counts_ref, act_ref, nu_ref, nuc_ref,
                     sx_ref, y_ref, *rest, cutoff: Optional[float],
                     n_basis: int, n_rows: int, block_l: int, has_chi: bool):
    """One (state b, nu tile i) program.

    starts/counts_ref: [n_tiles] int32 line-block window per tile;
    act_ref: [B] int32 (0 = state whose coefficients are all zero: it
    contributes exactly 0, so its loop runs no iterations — in a limb scan
    the layers below each ray's tangent point are ~45 % of the (ray x
    layer) rectangle).  nu_ref: [TILE_P]; nuc/sx/y(/chi)_ref: [Lp] lines of
    state b; n_basis coefficient refs [n_rows, Lp]; out_ref [n_rows, TILE_P].
    """
    chb_ref = rest[0] if has_chi else None
    c_refs = rest[len(rest) - 1 - n_basis:-1]
    out_ref = rest[-1]
    b = pl.program_id(0)
    i = pl.program_id(1)
    nu = nu_ref[...]
    tile_p = nu.shape[0]
    nu_lo, nu_hi = jnp.min(nu), jnp.max(nu)
    start = starts_ref[i]
    n_blk = jnp.where(act_ref[b] != 0, counts_ref[i], 0)
    use_dot = n_rows > _SUM_ROWS
    n_acc = n_rows // _ROW_CHUNK if use_dot else n_rows

    def body(j, accs):
        sl = pl.ds((start + j) * block_l, block_l)
        nuc, sxv, yv = nuc_ref[sl], sx_ref[sl], y_ref[sl]
        dnu = nu[:, None] - nuc[None, :]                 # [TILE_P, BLOCK_L]
        x = dnu * sxv[None, :]
        y = jnp.broadcast_to(yv[None, :], x.shape)
        # Conservative block bound on s = |x| + y (lines and grid sorted).
        gap = jnp.maximum(jnp.maximum(jnp.min(nuc) - nu_hi,
                                      nu_lo - jnp.max(nuc)), 0.0)
        y_min = jnp.min(yv)
        s_min = gap * jnp.min(sxv) + y_min
        if n_basis == 1:
            basis = (_wr_tile(x, y, s_min, y_min),)
        else:
            basis = _basis_tile(x, y, s_min, y_min)
        if has_chi:
            # Frozen-chi convention (ops/chi.py): chi scales every basis row.
            ch = jnp.exp(-chb_ref[sl][None, :] * jnp.maximum(
                jnp.abs(dnu) - CHI_DELTA1, 0.0))
            basis = tuple(B * ch for B in basis)
        if cutoff is not None:
            inside = jnp.abs(dnu) <= cutoff
            basis = tuple(jnp.where(inside, B, 0.0) for B in basis)
        out = []
        for k in range(n_acc):
            acc = accs[k]
            for c_ref, B in zip(c_refs, basis):
                if use_dot:
                    # [CHUNK, BLOCK_L] x [TILE_P, BLOCK_L] -> [CHUNK, TILE_P]
                    acc = acc + jax.lax.dot_general(
                        c_ref[pl.ds(k * _ROW_CHUNK, _ROW_CHUNK), sl], B,
                        dimension_numbers=(((1,), (1,)), ((), ())),
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
                else:
                    acc = acc + jnp.sum(B * c_ref[k, sl][None, :], axis=1)
            out.append(acc)
        return tuple(out)

    shape = (_ROW_CHUNK, tile_p) if use_dot else (tile_p,)
    init = tuple(jnp.zeros(shape, jnp.float32) for _ in range(n_acc))
    accs = jax.lax.fori_loop(0, n_blk, body, init)
    for k, acc in enumerate(accs):
        if use_dot:
            out_ref[pl.ds(k * _ROW_CHUNK, _ROW_CHUNK), :] = acc
        else:
            out_ref[k, :] = acc


@functools.partial(jax.jit, static_argnames=("tile_p", "block_l",
                                             "cutoff_cm1", "interpret"))
def _line_sum(nu_grid, nu_c, sx, y, coeffs, starts, counts, active,
              chi_b=None, *, tile_p, block_l, cutoff_cm1, interpret):
    """Pad and launch: nu_grid [P]; nu_c/sx/y(/chi_b) [B, L]; coeffs: a
    tuple of 1 (primal) or 4 (basis) arrays [B, R, L]; starts/counts
    [n_tiles] int32; active [B] int32.  Returns [B, R, P] float32.

    Pad fills: grid points beyond P sit far above the data, lines beyond L
    are zero-amplitude and "far" (huge scale_x / y) so block minima — the
    dispatch bound — reflect only real lines.  Fills are data-relative
    (traced max), so the invariants hold for any coordinate origin."""
    P = nu_grid.shape[0]
    B, L = nu_c.shape
    R = coeffs[0].shape[1]
    Pp = _round_up(max(P, tile_p), tile_p)
    Lp = _round_up(max(L, block_l), block_l)
    Rp = R if R <= _SUM_ROWS else _round_up(R, _ROW_CHUNK)
    n_tiles = Pp // tile_p
    far_nu = jnp.max(nu_grid).astype(jnp.float32) + 1e6
    far_line = jnp.max(nu_c).astype(jnp.float32) + 1e7
    nu_pad = jnp.full((Pp,), far_nu, jnp.float32).at[:P].set(
        nu_grid.astype(jnp.float32))
    padl = lambda a, fill: jnp.full((B, Lp), fill, jnp.float32).at[:, :L].set(
        a.astype(jnp.float32))
    padc = lambda C: jnp.zeros((B, Rp, Lp), jnp.float32).at[:, :R, :L].set(
        C.astype(jnp.float32))
    has_chi = chi_b is not None

    table = pl.BlockSpec((n_tiles,), lambda b, i: (0,))
    line = pl.BlockSpec((None, Lp), lambda b, i: (b, 0))
    in_specs = [table, table, pl.BlockSpec((B,), lambda b, i: (0,)),
                pl.BlockSpec((tile_p,), lambda b, i: (i,)), line, line, line]
    ins = [jnp.asarray(starts, jnp.int32), jnp.asarray(counts, jnp.int32),
           jnp.asarray(active, jnp.int32), nu_pad, padl(nu_c, far_line),
           padl(sx, 1e6), padl(y, 1e6)]
    if has_chi:
        in_specs.append(line)
        ins.append(padl(chi_b, 0.0))
    in_specs += [pl.BlockSpec((None, Rp, Lp), lambda b, i: (b, 0, 0))] \
        * len(coeffs)
    ins += [padc(C) for C in coeffs]
    kern = functools.partial(_line_sum_kernel, cutoff=cutoff_cm1,
                             n_basis=len(coeffs), n_rows=Rp,
                             block_l=block_l, has_chi=has_chi)
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((B, Rp, Pp), jnp.float32),
        grid=(B, n_tiles),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((None, Rp, tile_p), lambda b, i: (b, 0, i)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=_NUM_STAGES),
        interpret=interpret,
        name="voigt_line_sum" if len(coeffs) == 1 else "voigt_basis_sum",
    )(*ins)
    return out[:, :R, :P]


def _block_windows(nu_host: np.ndarray, nuc_host: np.ndarray, tile_p: int,
                   block_l: int, cutoff: Optional[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: for each nu tile, the [start, count) of line BLOCKS whose
    lines can reach the tile given the wing cutoff (lines sorted by nu0)."""
    n_tiles = len(nu_host) // tile_p
    n_blocks = len(nuc_host) // block_l
    if cutoff is None:
        starts = np.zeros(n_tiles, dtype=np.int32)
        counts = np.full(n_tiles, n_blocks, dtype=np.int32)
        return starts, counts
    blk_min = nuc_host.reshape(n_blocks, block_l).min(axis=1)
    blk_max = nuc_host.reshape(n_blocks, block_l).max(axis=1)
    tile_lo = nu_host.reshape(n_tiles, tile_p).min(axis=1)
    tile_hi = nu_host.reshape(n_tiles, tile_p).max(axis=1)
    # Block b is relevant to tile t iff [blk_min-cut, blk_max+cut] overlaps
    # [tile_lo, tile_hi].
    starts = np.searchsorted(blk_max, tile_lo - cutoff, side="left")
    ends = np.searchsorted(blk_min, tile_hi + cutoff, side="right")
    starts = np.minimum(starts, n_blocks).astype(np.int32)
    counts = np.maximum(ends - starts, 0).astype(np.int32)
    return starts, counts


def static_windows(nu_host: np.ndarray, nu0_host: np.ndarray, *,
                   tile_p: int = DEFAULT_TILE_P, block_l: int = DEFAULT_BLOCK_L,
                   cutoff_cm1: Optional[float] = 25.0,
                   shift_margin_cm1: float = 1.0):
    """Host-side ragged block windows for the JIT-COMPOSABLE kernel entry
    points: when the (static) grid and unshifted line centers are concrete
    at trace time — closure constants of a jitted forward, the common case
    (retrieval.state.build_forward) — the per-tile [start, count) tables are
    baked in as compile-time constants, and each program's loop visits only
    the blocks that can reach its tile.

    Pads exactly the way :func:`_line_sum` pads (far fills), and widens
    the window by ``shift_margin_cm1`` to cover any pressure shift, so
    results stay bit-identical to the all-blocks evaluation (the in-kernel
    |dnu| <= cutoff mask is unchanged and exact).

    Returns (starts [n_tiles] int32, counts [n_tiles] int32, max_blocks).
    """
    nu_host = np.asarray(nu_host, np.float32)
    nu0_host = np.asarray(nu0_host, np.float32)
    P, L = len(nu_host), len(nu0_host)
    Pp = _round_up(max(P, tile_p), tile_p)
    Lp = _round_up(max(L, block_l), block_l)
    nu_pad = np.full(Pp, (nu_host.max() if P else 0.0) + 1e6, np.float32)
    nu_pad[:P] = nu_host
    nu0_pad = np.full(Lp, (nu0_host.max() if L else 0.0) + 1e7, np.float32)
    nu0_pad[:L] = nu0_host
    win_cut = None if cutoff_cm1 is None else cutoff_cm1 + shift_margin_cm1
    starts, counts = _block_windows(nu_pad, nu0_pad, tile_p, block_l,
                                    win_cut)
    max_blocks = max(int(counts.max()) if counts.size else 1, 1)
    return starts, counts, max_blocks


def _window_tables(P: int, L: int, tile_p: int, block_l: int, windows):
    """(starts, counts) from ``windows`` = (starts, counts, max_blocks) —
    baked constants or traced per-shard tables — or all-blocks if None."""
    if windows is None:
        n_tiles = _round_up(max(P, tile_p), tile_p) // tile_p
        n_blocks = _round_up(max(L, block_l), block_l) // block_l
        return (jnp.zeros((n_tiles,), jnp.int32),
                jnp.full((n_tiles,), n_blocks, jnp.int32))
    st, ct = windows[0], windows[1]
    return jnp.asarray(st, jnp.int32), jnp.asarray(ct, jnp.int32)


def accumulate_pallas_batch_jit(nu_grid, nu_c, sx, y, amps, *,
                                tile_p: int = DEFAULT_TILE_P,
                                block_l: int = DEFAULT_BLOCK_L,
                                cutoff_cm1: Optional[float] = 25.0,
                                interpret: bool = False,
                                windows=None,
                                chi_b=None) -> jnp.ndarray:
    """Batched stage-2 accumulation, jit-composable (all inputs may be
    traced): nu_c/sx/y [B, L], amps [B, n_out, L] -> [B, n_out, P] float32.

    ``windows`` = (starts, counts, max_blocks) ragged block tables from
    :func:`static_windows` (constant or traced); default visits every
    block.  All-zero states are skipped in-kernel (bit-exact)."""
    starts, counts = _window_tables(nu_grid.shape[0], nu_c.shape[1], tile_p,
                                    block_l, windows)
    active = jnp.any(amps != 0, axis=(1, 2)).astype(jnp.int32)
    return _line_sum(nu_grid, nu_c, sx, y, (amps,), starts, counts, active,
                     chi_b, tile_p=tile_p, block_l=block_l,
                     cutoff_cm1=cutoff_cm1, interpret=interpret)


def accumulate_pallas_batch(
    nu_grid: jnp.ndarray,
    nu0_host: np.ndarray,
    nu_c: jnp.ndarray,
    scale_x: jnp.ndarray,
    y: jnp.ndarray,
    amps: jnp.ndarray,
    *,
    tile_p: int = DEFAULT_TILE_P,
    block_l: int = DEFAULT_BLOCK_L,
    cutoff_cm1: Optional[float] = 25.0,
    shift_margin_cm1: float = 1.0,
    interpret: bool = False,
    chi_b=None,
) -> jnp.ndarray:
    """Batched stage-2 accumulation with host-known windows: nu_c/scale_x/y
    [B, L], amps [B, n_out, L] -> [B, n_out, P] float32.  ``chi_b`` [B, L]:
    optional sub-Lorentzian wing slopes (ops.chi; 0/None = off).

    The block windows are computed ONCE from the host-known UNSHIFTED line
    centers ``nu0_host`` (sorted, C1), widened by ``shift_margin_cm1`` to
    cover any pressure shift, and shared across the batch — the in-kernel
    |dnu| <= cutoff mask does the exact per-element windowing, so results
    match the jnp path to roundoff.
    """
    windows = static_windows(np.asarray(nu_grid), nu0_host, tile_p=tile_p,
                             block_l=block_l, cutoff_cm1=cutoff_cm1,
                             shift_margin_cm1=shift_margin_cm1)
    return accumulate_pallas_batch_jit(
        nu_grid, nu_c, scale_x, y, amps, tile_p=tile_p, block_l=block_l,
        cutoff_cm1=cutoff_cm1, interpret=interpret, windows=windows,
        chi_b=chi_b)


def accumulate_pallas(
    nu_grid: jnp.ndarray,
    kl: KernelLines,
    *,
    tile_p: int = DEFAULT_TILE_P,
    block_l: int = DEFAULT_BLOCK_L,
    cutoff_cm1: Optional[float] = 25.0,
    interpret: bool = False,
) -> jnp.ndarray:
    """Single-state stage-2 accumulation with windows from the (host-known,
    already shifted) line centers: [n_out, P] float32.  Call outside jit."""
    out = accumulate_pallas_batch(
        nu_grid, np.asarray(kl.nu_c), kl.nu_c[None], kl.scale_x[None],
        kl.y[None], kl.amps[None], tile_p=tile_p, block_l=block_l,
        cutoff_cm1=cutoff_cm1, shift_margin_cm1=0.0, interpret=interpret,
        chi_b=None if kl.chi_b is None else kl.chi_b[None])
    return out[0]


# ---------------------------------------------------------------------------
# Fused analytic-Jacobian basis
# ---------------------------------------------------------------------------
#
# The analytic tangent of the line sum decomposes over the four
# tangent-independent basis functions {K, Kx, xKx, Ky} contracted with
# per-line coefficient rows (ops/opacity.py "analytic custom JVP" notes).
# The kernel evaluates the four basis tiles in registers — with the same
# tier dispatch as the primal, each tier differentiating exactly the
# formula the primal uses — and contracts all of them against four
# coefficient inputs in one pass:
#
#     out[r, p] = sum_i ( C1[r,i] K + C2[r,i] Kx + C3[r,i] xKx + C4[r,i] Ky )
#
# The row axis r carries EVERY Jacobian column at once (r = tangent x
# spectrum), so the expensive basis evaluation is paid once per Jacobian
# and never written to device memory.


def basis_contract_pallas_batch_jit(nu_grid, nu_c, sx, y, C1, C2, C3, C4,
                                    *, tile_p: int = DEFAULT_TILE_P,
                                    block_l: int = DEFAULT_BLOCK_L,
                                    cutoff_cm1: Optional[float] = 25.0,
                                    interpret: bool = False,
                                    windows=None,
                                    active=None, chi_b=None) -> jnp.ndarray:
    """Batched fused basis contraction, jit-composable.

    nu_c/sx/y: [B, L]; C1..C4: [B, R, L].  Returns [B, R, P] float32.
    ``windows``: ragged windows, constant or traced (see
    :func:`accumulate_pallas_batch_jit`).  ``active`` [B] (int32; 0 =
    skip): states whose FOUR coefficient inputs are all zero produce
    exactly 0 and are skipped in-kernel; default derives the mask from
    C1..C4 on device (callers who know a cheaper sufficient statistic —
    e.g. the tangent fold, where C2..C4 are amps-scaled so cat(amps, C1)
    covers everything — pass it).
    """
    starts, counts = _window_tables(nu_grid.shape[0], nu_c.shape[1], tile_p,
                                    block_l, windows)
    if active is None:
        nz = lambda C: jnp.any(C != 0, axis=(1, 2))
        active = nz(C1) | nz(C2) | nz(C3) | nz(C4)
    return _line_sum(nu_grid, nu_c, sx, y, (C1, C2, C3, C4), starts, counts,
                     jnp.asarray(active, jnp.int32), chi_b, tile_p=tile_p,
                     block_l=block_l, cutoff_cm1=cutoff_cm1,
                     interpret=interpret)


def basis_contract_pallas_jit(nu_grid, nu_c, sx, y, C1, C2, C3, C4,
                              *, windows=None, chi_b=None,
                              **kw) -> jnp.ndarray:
    """Fused basis contraction for one state: nu_c/sx/y [L], C1..C4 [R, L]
    -> [R, P] float32 (the batch kernel with B = 1)."""
    out = basis_contract_pallas_batch_jit(
        nu_grid, nu_c[None], sx[None], y[None], C1[None], C2[None],
        C3[None], C4[None], windows=windows,
        chi_b=None if chi_b is None else chi_b[None], **kw)
    return out[0]
