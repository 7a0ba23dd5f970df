"""Multi-layer limb/nadir forward model (layer L3, SURVEY.md 2.2; C13).

Assembles the full radiance pipeline of the reference's call stack 4.1
(fedef17/SpectRobot ``radtran`` path) as one jit-able, differentiable tensor
program: Curtis-Godson states -> per-(ray, layer) opacity line sums (stage-2
kernel) -> segment gather -> cumulative-transmittance RT -> (optional) ILS.

Design notes:
* The (ray x layer) batch is a single vmap-of-vmap over the stage-2 kernel;
  per-species CG states are scattered per line (see ops/opacity.py), so one
  line-sum per (ray, layer) covers every species AND both non-LTE spectra.
* The emission-to-absorption ratio forms the non-LTE source function
  S_nu = B_nu(T_air) * k_em / k_abs (ops/planck.py derivation); in LTE the
  ratio is exactly 1 and S_nu = B_nu.
* Limb rays reuse one-side optical depths for both crossings (spherical
  symmetry) — half the line-sum work of a naive per-segment evaluation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from spectrobot_tpu.data.nlte import DeviceNLTE, weights_for_layer
from spectrobot_tpu.forward.geometry import PathCG
from spectrobot_tpu.forward.rt import radiance_along_ray
from spectrobot_tpu.ops.opacity import line_kernel_inputs
from spectrobot_tpu.ops.planck import planck_nu
from spectrobot_tpu.ops.strengths import DeviceLines


class LayerOptics(NamedTuple):
    dtau: jnp.ndarray     # [R, NL, P] one-crossing optical depth
    source: jnp.ndarray   # [R, NL, P] source-function radiance


def _clamp_chunk(chunk: int, n_states: int, n_points: int,
                 itemsize: int = 4, budget_bytes: float = 5.0e8) -> int:
    """Bound the XLA engine's per-scan-step (n_states, chunk, n_points)
    Voigt slab to ``budget_bytes`` (floor 8 lines); ``itemsize`` from the
    compute dtype (f64 slabs are 2x f32 — round-4 review finding)."""
    max_chunk = max(8, int(budget_bytes
                           // max(n_states * n_points * itemsize, 1)))
    return min(chunk, max_chunk)


def layer_tau(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    cg: PathCG,
    nlte: Optional[DeviceNLTE] = None,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    analytic_jvp=True,  # True/"fwd" | "rev" | False (ops.opacity._ad_mode)
    nu_off: Optional[jnp.ndarray] = None,
    engine: str = "jnp",
    interpret: bool = False,
    windows=None,
    chi=None,
):
    """Raw per-(ray, layer) line sums: (dtau, dtau_em), each [R, NL, P].

    ``chi`` = (ops.chi.ChiProfile, row_mask [n_species]): sub-Lorentzian
    wing correction for the profile's species (ops/chi.py; None = off,
    bit-identical).

    ``nu_off``: the grid in OFFSET coordinates (nu - lines.nu_ref), staged
    from float64 by the caller for f32-precision dnu; default computes it
    from ``nu_grid`` (exact for f64 grids, see DeviceLines docstring).

    ``windows``: explicit ragged kernel windows (engine='pallas'; see
    ops.pallas_opacity.static_windows) — pass per-shard
    tables from inside shard_map bodies, where the auto-computation below
    cannot run (traced centers).

    These are LINEAR in the line list, so a line-sharded mesh can psum them
    across the 'line' axis before the (nonlinear) source assembly — the
    split that makes C23 line-parallelism exact (SURVEY.md C23).
    """
    from spectrobot_tpu.ops.opacity import _ad_mode, make_accumulate_op

    R, NL, S = cg.u.shape
    lay_ids = jnp.arange(NL, dtype=jnp.int32)
    if nu_off is None:
        nu_off = nu_grid - lines.nu_ref.astype(nu_grid.dtype)
    if engine != "pallas":
        # The XLA engine's line-chunk scan materialises a (R*NL, chunk, P)
        # Voigt slab per step under this function's vmap-of-vmap (x4 slabs
        # under the tangent basis); clamp the chunk so that stays bounded —
        # a plain memory bound (5e8 bytes per slab; the budget is not yet
        # derived from the device's memory).  No-op for ordinary scenes;
        # the kernel engine keeps its tiles in registers and needs no
        # clamp.
        chunk = _clamp_chunk(chunk, R * NL, int(nu_off.shape[-1]),
                             itemsize=jnp.dtype(nu_off.dtype).itemsize)
    # Pallas engine: when the grid and line centers are CONCRETE at trace
    # time (closure constants of a jitted forward — the build_forward
    # case), bake real ragged block windows in as static tables so the
    # kernel skips provably-out-of-cutoff blocks instead of just
    # region-dispatching them (bit-identical results; the in-kernel cutoff
    # mask is unchanged).  Traced centers (e.g. inside shard_map bodies)
    # fall back to all-blocks.
    if windows is None and engine == "pallas" \
            and cutoff_cm1 is not None and not (
            isinstance(nu_off, jax.core.Tracer)
            or isinstance(lines.nu0, jax.core.Tracer)):
        import numpy as np

        from spectrobot_tpu.ops.pallas_opacity import static_windows
        windows = static_windows(np.asarray(nu_off), np.asarray(lines.nu0),
                                 cutoff_cm1=cutoff_cm1)
    # Accumulation op with ANALYTIC derivatives: under jacfwd the Voigt
    # basis is shared across every Jacobian column (SURVEY.md 8.4 hard part
    # 3); analytic_jvp='rev' swaps in the custom-VJP op (grad/jacrev via the
    # explicit transpose); False falls back to plain-AD accumulation.
    if chi is not None:
        from spectrobot_tpu.ops.chi import CHI_MAX_CUTOFF
        if cutoff_cm1 is None or cutoff_cm1 > CHI_MAX_CUTOFF:
            raise ValueError(
                f"the chi wing correction implements the first "
                f"Perrin-Hartmann segment only (valid to "
                f"{CHI_MAX_CUTOFF} cm^-1); compute.cutoff_cm1="
                f"{cutoff_cm1} exceeds it — lower the cutoff or disable "
                f"lines.chi")
    mode = _ad_mode(analytic_jvp)
    if mode is not None:
        acc_op = make_accumulate_op(chunk=chunk, variant=variant,
                                    cutoff_cm1=cutoff_cm1, engine=engine,
                                    interpret=interpret, mode=mode,
                                    windows=windows,
                                    has_chi=chi is not None)
    else:
        from spectrobot_tpu.ops.opacity import accumulate_jnp
        from spectrobot_tpu.ops.opacity import KernelLines as _KL

        def acc_op(nu, nc, sx, yy, am, cb=None):
            return accumulate_jnp(nu, _KL(nc, sx, yy, am, cb), chunk=chunk,
                                  variant=variant, cutoff_cm1=cutoff_cm1)

    def one(u_sp, T_sp, p_sp, ps_sp, T_air, lay_idx):
        sp = lines.species_idx
        T_line = T_sp[sp]
        p_line = p_sp[sp]
        ps_line = ps_sp[sp]
        u_line_cm2 = u_sp[sp] * 1.0e-4           # [L] molec cm^-2 (one side)
        w_abs, w_em = weights_for_layer(nlte, lines, lay_idx, T_air)
        amps = jnp.stack([w_abs * u_line_cm2, w_em * u_line_cm2])
        kl = line_kernel_inputs(lines, T_line, p_line, ps_line, amps,
                                chi=chi)
        if kl.chi_b is None:
            out = acc_op(nu_off, kl.nu_c, kl.scale_x, kl.y, kl.amps)
        else:
            out = acc_op(nu_off, kl.nu_c, kl.scale_x, kl.y, kl.amps,
                         kl.chi_b)
        return out[0], out[1]                    # dtau, "emission depth"

    per_layer = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))
    per_ray = jax.vmap(per_layer, in_axes=(0, 0, 0, 0, 0, None))
    return per_ray(cg.u, cg.T_sp, cg.p_sp, cg.p_self_sp, cg.T_air, lay_ids)


def optics_from_tau(nu_grid, cg: PathCG, dtau, dtau_em) -> LayerOptics:
    """Source assembly: S_nu = B_nu(T_air) * k_em/k_abs (LTE: ratio = 1).

    The ratio threshold must keep dtau^2 in NORMAL float range (the division
    JVP squares the denominator): 1e-16 in f32 (emitted radiance below
    B*1e-16 is far under any sensor noise floor), 1e-150 in f64.
    """
    B = planck_nu(nu_grid[None, None, :], cg.T_air[:, :, None])
    tiny = jnp.asarray(1e-150 if dtau.dtype == jnp.float64 else 1e-16,
                       dtau.dtype)
    ratio = dtau_em / jnp.maximum(dtau, tiny)
    source = B * jnp.where(dtau > tiny, ratio, 1.0)
    return LayerOptics(dtau=dtau, source=source)


def layer_optics(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    cg: PathCG,
    nlte: Optional[DeviceNLTE] = None,
    cia=None,
    **kw,
) -> LayerOptics:
    """Per-(ray, layer) optical depth and source spectra.

    ``cia`` (ops.cia.DeviceCIA) adds the collision-induced continuum to
    BOTH depths before source assembly — CIA thermalises at the kinetic
    temperature, so this pulls non-LTE sources toward B_nu(T_air) exactly
    where the continuum dominates (round-1 review item 7).
    """
    dtau, dtau_em = layer_tau(nu_grid, lines, cg, nlte, **kw)
    if cia is not None:
        from spectrobot_tpu.ops.cia import cia_dtau
        dc = cia_dtau(cia, cg).astype(dtau.dtype)
        dtau = dtau + dc
        dtau_em = dtau_em + dc
    return optics_from_tau(nu_grid, cg, dtau, dtau_em)


def _tau_prologue(lines: DeviceLines, cg: PathCG,
                  nlte: Optional[DeviceNLTE], chi=None):
    """Vectorised stage-1: CG states -> flat per-(ray*layer) kernel inputs.

    Returns (nu_c, scale_x, y, amps, chi_b): [B, L], amps [B, 2, L],
    chi_b [B, L] or None, B = R*NL.
    """
    R, NL, S = cg.u.shape
    lay_ids = jnp.arange(NL, dtype=jnp.int32)

    def one(u_sp, T_sp, p_sp, ps_sp, T_air, lay_idx):
        sp = lines.species_idx
        u_line_cm2 = u_sp[sp] * 1.0e-4
        w_abs, w_em = weights_for_layer(nlte, lines, lay_idx, T_air)
        amps = jnp.stack([w_abs * u_line_cm2, w_em * u_line_cm2])
        kl = line_kernel_inputs(lines, T_sp[sp], p_sp[sp], ps_sp[sp], amps,
                                chi=chi)
        cb = (jnp.zeros_like(kl.y) if kl.chi_b is None else kl.chi_b)
        return kl.nu_c, kl.scale_x, kl.y, kl.amps, cb

    per_layer = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))
    per_ray = jax.vmap(per_layer, in_axes=(0, 0, 0, 0, 0, None))
    nu_c, sx, y, amps, cb = per_ray(cg.u, cg.T_sp, cg.p_sp, cg.p_self_sp,
                                    cg.T_air, lay_ids)
    L = lines.n_lines
    return (nu_c.reshape(R * NL, L), sx.reshape(R * NL, L),
            y.reshape(R * NL, L), amps.reshape(R * NL, 2, L),
            cb.reshape(R * NL, L) if chi is not None else None)


_tau_prologue_jit = jax.jit(_tau_prologue, static_argnums=(3,))


def layer_tau_pallas(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    cg: PathCG,
    nlte: Optional[DeviceNLTE] = None,
    *,
    cutoff_cm1: Optional[float] = 25.0,
    tile_p: Optional[int] = None,
    block_l: Optional[int] = None,
    interpret: bool = False,
    nu_off: Optional[jnp.ndarray] = None,
    chi=None,
):
    """Pallas-kernel stage 2 for the whole (ray x layer) batch: ONE
    pallas_call covers every layer of every ray (SURVEY.md M2/M3 production
    path).  Host-side block windows come from the unshifted line centers, so
    this entry point runs OUTSIDE jit (prologue and kernel are jitted
    internally).  Returns (dtau, dtau_em) [R, NL, P] float32."""
    from spectrobot_tpu.ops.pallas_opacity import (
        DEFAULT_BLOCK_L, DEFAULT_TILE_P, accumulate_pallas_batch)
    import numpy as np

    R, NL, S = cg.u.shape
    if nu_off is None:
        nu_off = nu_grid - lines.nu_ref.astype(nu_grid.dtype)
    nu_c, sx, y, amps, chi_b = _tau_prologue_jit(lines, cg, nlte, chi)
    out = accumulate_pallas_batch(
        nu_off, np.asarray(lines.nu0), nu_c, sx, y, amps,
        tile_p=DEFAULT_TILE_P if tile_p is None else tile_p,
        block_l=DEFAULT_BLOCK_L if block_l is None else block_l,
        cutoff_cm1=cutoff_cm1, interpret=interpret,
        chi_b=chi_b)       # [B, 2, P]
    P = nu_grid.shape[0]
    out = out.reshape(R, NL, 2, P)
    return out[:, :, 0, :], out[:, :, 1, :]


def limb_radiance_pallas(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    cg: PathCG,
    nlte: Optional[DeviceNLTE] = None,
    I_background: Optional[jnp.ndarray] = None,
    cia=None,
    **kw,
) -> jnp.ndarray:
    """Full limb/nadir radiance with the Pallas opacity kernel (call outside
    jit; the RT epilogue is jitted internally)."""
    dtau, dtau_em = layer_tau_pallas(nu_grid, lines, cg, nlte, **kw)
    if cia is not None:
        from spectrobot_tpu.ops.cia import cia_dtau
        dc = cia_dtau(cia, cg).astype(dtau.dtype)
        dtau, dtau_em = dtau + dc, dtau_em + dc
    return _rt_epilogue_jit(nu_grid, cg, dtau, dtau_em, I_background)


@jax.jit
def _rt_epilogue(nu_grid, cg, dtau, dtau_em, bg):
    optics = optics_from_tau(nu_grid.astype(dtau.dtype), cg, dtau, dtau_em)
    return path_radiance(optics, cg, bg)


_rt_epilogue_jit = _rt_epilogue


def tau_radiance_epilogue(
    nu_grid: jnp.ndarray,
    cg: PathCG,
    dtau: jnp.ndarray,
    dtau_em: jnp.ndarray,
    cia=None,
    I_background: Optional[jnp.ndarray] = None,
    is_limb: bool = True,
    emissivity=1.0,
) -> jnp.ndarray:
    """THE local radiance epilogue from precomputed line-sum depths
    [R, NL, P]: add the (additive, line-free) CIA continuum to both depths,
    assemble sources, and for a nadir path with a grey surface
    (``is_limb=False``, ``I_background`` = eps*B(T_s)) add the Lambertian
    reflected downwelling.  Every operation is pointwise in (ray, nu), so
    this one function serves the single-device tails AND the shard_map
    bodies (parallel/sharded.py, parallel/sharded_lut.py) unchanged — one
    place to fix, three call sites (round-3 code-review item)."""
    if cia is not None:
        from spectrobot_tpu.ops.cia import cia_dtau
        dc = cia_dtau(cia, cg).astype(dtau.dtype)
        dtau, dtau_em = dtau + dc, dtau_em + dc
    optics = optics_from_tau(nu_grid, cg, dtau, dtau_em)
    if not is_limb and not (isinstance(emissivity, (int, float))
                            and emissivity >= 1.0):
        I_background = I_background + (1.0 - emissivity) * \
            downwelling_radiance(optics, cg)
    return path_radiance(optics, cg, I_background)


def radiance_from_tau(
    nu_grid: jnp.ndarray,
    cg: PathCG,
    dtau: jnp.ndarray,
    dtau_em: jnp.ndarray,
    cia=None,
    T_surface=None,
    emissivity=1.0,
    I_background: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """RT epilogue from PRECOMPUTED line-sum depths [R, NL, P] — the shared
    tail of the LUT runtime tier (ops/lut.py, reference call stack 4.3) and
    any external opacity source.  Limb when ``T_surface`` is None (deep
    space or ``I_background`` behind), nadir otherwise (grey surface with
    Lambertian reflected downwelling, as :func:`nadir_radiance`)."""
    if T_surface is None:
        return tau_radiance_epilogue(nu_grid, cg, dtau, dtau_em, cia=cia,
                                     I_background=I_background)
    I_bg = emissivity * planck_nu(nu_grid, T_surface)
    I_bg = jnp.broadcast_to(I_bg, (dtau.shape[0], nu_grid.shape[0]))
    return tau_radiance_epilogue(nu_grid, cg, dtau, dtau_em, cia=cia,
                                 I_background=I_bg, is_limb=False,
                                 emissivity=emissivity)


def path_radiance(
    optics: LayerOptics,
    cg: PathCG,
    I_background: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Integrate layer optics in the observer-first segment order:
    returns radiance [R, P] (forward.rt.layer_path_radiance)."""
    from spectrobot_tpu.forward.rt import layer_path_radiance
    return layer_path_radiance(optics.dtau, optics.source, cg.seg_layer,
                               I_background)


def limb_radiance(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    cg: PathCG,
    nlte: Optional[DeviceNLTE] = None,
    **kw,
) -> jnp.ndarray:
    """Limb scan radiances [R, P] (configs 2/3, BASELINE.json:8-9).
    Background is deep space (0)."""
    optics = layer_optics(nu_grid, lines, cg, nlte, **kw)
    return path_radiance(optics, cg, None)


def nadir_radiance(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    cg: PathCG,
    T_surface,
    emissivity: float = 1.0,
    nlte: Optional[DeviceNLTE] = None,
    **kw,
) -> jnp.ndarray:
    """Nadir radiances [R, P] over a grey surface.

    For emissivity < 1 the surface boundary includes the REFLECTED
    downwelling (Lambertian, same-angle approximation):

        I_surface = eps * B(T_s) + (1 - eps) * I_down,

    where I_down is the sky radiance reaching the surface — the same layer
    optics integrated in the reversed (surface-first) segment order, at no
    extra line-sum cost.  Kirchhoff sanity: an isothermal atmosphere +
    surface at temperature T radiates exactly B(T) at ANY emissivity
    (tested in test_limb_config2.py)."""
    optics = layer_optics(nu_grid, lines, cg, nlte, **kw)
    I_bg = emissivity * planck_nu(nu_grid, T_surface)
    I_bg = jnp.broadcast_to(I_bg, (optics.dtau.shape[0], nu_grid.shape[0]))
    # Skip the downwelling pass only when emissivity is STATICALLY 1
    # (a traced emissivity — e.g. a retrieved surface parameter — always
    # carries the reflection term; it is linear-algebra cheap).
    if not (isinstance(emissivity, (int, float)) and emissivity >= 1.0):
        down = downwelling_radiance(optics, cg)
        I_bg = I_bg + (1.0 - emissivity) * down
    return path_radiance(optics, cg, I_bg)


def downwelling_radiance(optics: LayerOptics, cg: PathCG) -> jnp.ndarray:
    """Sky radiance arriving at the surface [R, P]: the same layer optics
    integrated surface-first (reversed segment order), deep space behind."""
    from spectrobot_tpu.forward.rt import layer_path_radiance
    return layer_path_radiance(optics.dtau, optics.source,
                               cg.seg_layer[::-1], None)
