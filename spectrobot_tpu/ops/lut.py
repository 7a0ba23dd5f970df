"""(P, T) opacity look-up tables (component C9, SURVEY.md).

The reference (fedef17/SpectRobot ``makeLUT*`` [SURVEY.md 1.2/4.3]) precomputes
absorption/emission coefficients per species/level on a (P, T) grid with a
multiprocessing pool, then interpolates at runtime.  Position
(SURVEY.md C9): on an accelerator, recomputing the line sum is often FASTER than
streaming a big LUT from HBM, so the LUT is a CACHE TIER, not the core path —
useful for very large line lists on small grids, for CPU fallbacks, and for
serving scenarios that amortise a build across many retrievals.

Design: one dense table ``sigma[S, nT, nQ, P]`` of absorption cross sections
on a (T, log10 p) lattice, built by the SAME stage-1/2 machinery as the
direct path (so LUT and direct agree to interpolation error by construction),
interpolated bilinearly in (T, log p) — fully differentiable, so retrieval
Jacobians flow through the table.

Two tiers live here:

* ``OpacityLUT`` — the LTE tier: one sigma table per species.
* ``NLTELUT`` — the non-LTE tier (reference ``makeLUT*`` builds PER-LEVEL
  coefficient tables [SURVEY.md 4.3/C9]).  The per-line non-LTE weights of
  :func:`spectrobot_tpu.data.nlte.weights_for_layer`,

      w_abs = (r_l - r_u E) / (1 - E),     w_em = r_u,
      E = exp(-c2 nu0 / T),

  are LINEAR in the level-population ratios r, so the line sum decomposes
  exactly into per-level-group coefficient tables:

      k_abs(nu) = sum_g r_g [ A_l,g(nu;T,p) - A_u,g(nu;T,p) ]
      k_em(nu)  = sum_g r_g M_g(nu;T,p)

      A_l,g = sum_{lines: lower in g} S V / (1-E)     (coefficient of r_lower)
      A_u,g = sum_{lines: upper in g} S V E / (1-E)   (stimulated emission)
      M_g   = sum_{lines: upper in g} S V             (spontaneous emission)

  with one extra "LTE" group PER SPECIES collecting unmatched lines
  (r = 1 identically: A_l - A_u = S V (1-E)/(1-E) = S V, the LTE sum).
  E is a function of the table temperature coordinate only, so the
  decomposition is exact at lattice nodes; runtime interpolates the tables
  bilinearly in (T, log p) and contracts with the CURRENT population
  ratios — T_vib profiles can change per retrieval iteration without a
  rebuild, which is the whole point of the reference's per-level LUTs.

Remaining limitations (documented): self-broadening is frozen at a
per-species VMR chosen at build time; the non-LTE tier evaluates E at the
per-species Curtis-Godson temperature rather than the layer air temperature
(the direct path uses T_air — the difference is well inside the tier's
interpolation error).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.constants import C2
from spectrobot_tpu.ops.opacity import cross_sections
from spectrobot_tpu.ops.strengths import DeviceLines


class OpacityLUT(NamedTuple):
    nu_grid: jnp.ndarray     # [P]
    T_grid: jnp.ndarray      # [nT] (uniform)
    logp_grid: jnp.ndarray   # [nQ] log10(p/Pa) (uniform)
    sigma: jnp.ndarray       # [S, nT, nQ, P] cm^2/molec
    vmr_self: jnp.ndarray    # [S] self-broadening VMR frozen at build


def _lattice_eval(one_point: Callable, T_grid, logp_grid,
                  mesh: Optional[jax.sharding.Mesh]) -> jnp.ndarray:
    """Evaluate ``one_point(T, logp) -> [...]`` over the (nT, nQ) lattice.

    Serial path: one jitted vmap batch per T row (bounded memory).
    Mesh path: the FLATTENED lattice is sharded over the mesh's devices and
    each device sweeps its own points with ``lax.map`` — the
    replacement for the reference's multiprocessing ``makeLUT*`` pool
    (SURVEY.md 4.3): every chip builds an equal slice of the lattice, and
    the gather back to host is the only cross-device traffic.
    """
    nT, nQ = T_grid.shape[0], logp_grid.shape[0]
    if mesh is None:
        one_row = jax.jit(jax.vmap(one_point, in_axes=(None, 0), out_axes=0))
        rows = [one_row(T_grid[ti], logp_grid) for ti in range(nT)]
        return jnp.stack(rows, axis=0)            # [nT, nQ, ...]

    from jax.sharding import NamedSharding, PartitionSpec as P

    shard_map = jax.shard_map
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    Tf = jnp.repeat(T_grid, nQ)                   # [nT*nQ]
    Qf = jnp.tile(logp_grid, nT)
    n_pts = Tf.shape[0]
    n_pad = (-n_pts) % n_dev
    Tf = jnp.concatenate([Tf, jnp.full((n_pad,), T_grid[0], Tf.dtype)])
    Qf = jnp.concatenate([Qf, jnp.full((n_pad,), logp_grid[0], Qf.dtype)])

    def local_sweep(Tl, Ql):
        return jax.lax.map(lambda tq: one_point(tq[0], tq[1]), (Tl, Ql))

    f = jax.jit(shard_map(local_sweep, mesh=mesh,
                          in_specs=(P(axis), P(axis)), out_specs=P(axis),
                          check_vma=False))
    sharding = NamedSharding(mesh, P(axis))
    out = f(jax.device_put(Tf, sharding), jax.device_put(Qf, sharding))
    return out[:n_pts].reshape((nT, nQ) + out.shape[1:])


def lut_mesh(n_devices: Optional[int] = None) -> jax.sharding.Mesh:
    """A 1-D mesh over (the first n) local devices for the lattice build."""
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return jax.sharding.Mesh(np.asarray(devs), ("lut_pt",))


def build_lut(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    n_species: int,
    T_min: float = 120.0, T_max: float = 320.0, n_T: int = 21,
    p_min: float = 1e-3, p_max: float = 2e3, n_p: int = 25,
    vmr_self: Optional[Sequence[float]] = None,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    mesh: Optional[jax.sharding.Mesh] = None,
    chi=None,
) -> OpacityLUT:
    """Build the table with the direct line-sum machinery (jit-batched over
    the (T, p) lattice; species separated by masking amplitudes).  Pass
    ``mesh`` (e.g. :func:`lut_mesh`) to shard the lattice build over
    devices.  ``chi`` (ops/chi.py) BAKES the sub-Lorentzian wing
    correction into the table: the slope b(T) rides the lattice T axis,
    so the runtime interpolation inherits it with no extra cost."""
    S = n_species
    vs = np.ones(S) if vmr_self is None else np.asarray(vmr_self, dtype=float)
    T_grid = jnp.linspace(T_min, T_max, n_T)
    logp_grid = jnp.linspace(np.log10(p_min), np.log10(p_max), n_p)
    dt = nu_grid.dtype

    def one_point(T, logp):
        p = 10.0 ** logp
        outs = []
        for s in range(S):
            mask = (lines.species_idx == s).astype(dt)
            sa, _ = cross_sections(
                nu_grid, lines, T, p, p_self_pa=float(vs[s]) * p,
                w_abs=mask, w_em=mask, chunk=chunk, variant=variant,
                cutoff_cm1=cutoff_cm1, analytic_jvp=False, chi=chi)
            outs.append(sa)
        return jnp.stack(outs)                    # [S, P]

    tbl = _lattice_eval(one_point, T_grid, logp_grid, mesh)  # [nT, nQ, S, P]
    sigma = jnp.moveaxis(tbl, 2, 0)               # [S, nT, nQ, P]
    return OpacityLUT(nu_grid=nu_grid, T_grid=T_grid, logp_grid=logp_grid,
                      sigma=sigma, vmr_self=jnp.asarray(vs, dt))


def _bilinear_tq(tbl: jnp.ndarray, T_grid, logp_grid, T, p_pa) -> jnp.ndarray:
    """Bilinear interpolation of ``tbl[..., nT, nQ, P]`` in (T, log10 p) at a
    scalar state -> [..., P].  Differentiable; clamps to the table boundary."""
    nT = T_grid.shape[0]
    nQ = logp_grid.shape[0]
    ft = (T - T_grid[0]) / (T_grid[1] - T_grid[0])
    fq = (jnp.log10(p_pa) - logp_grid[0]) / (logp_grid[1] - logp_grid[0])
    ft = jnp.clip(ft, 0.0, nT - 1.000001)
    fq = jnp.clip(fq, 0.0, nQ - 1.000001)
    it = jnp.floor(ft).astype(jnp.int32)
    iq = jnp.floor(fq).astype(jnp.int32)
    at = ft - it
    aq = fq - iq
    s00 = tbl[..., it, iq, :]
    s01 = tbl[..., it, iq + 1, :]
    s10 = tbl[..., it + 1, iq, :]
    s11 = tbl[..., it + 1, iq + 1, :]
    return ((1 - at) * (1 - aq) * s00 + (1 - at) * aq * s01
            + at * (1 - aq) * s10 + at * aq * s11)


def interp_sigma(lut: OpacityLUT, T, p_pa) -> jnp.ndarray:
    """Bilinear interpolation in (T, log10 p) -> sigma [S, P]."""
    return _bilinear_tq(lut.sigma, lut.T_grid, lut.logp_grid, T, p_pa)


def layer_tau_lut(lut: OpacityLUT, cg) -> jnp.ndarray:
    """LTE per-(ray, layer) optical depth from the LUT: dtau [R, NL, P].
    (dtau_em == dtau in LTE.)  Uses per-species CG states."""

    def one(u_sp, T_sp, p_sp):
        sig = jax.vmap(lambda s, T, p: interp_sigma(lut, T, p)[s],
                       in_axes=(0, 0, 0))(jnp.arange(u_sp.shape[0]), T_sp, p_sp)
        return jnp.sum(sig * (u_sp[:, None] * 1.0e-4), axis=0)   # [P]

    per_layer = jax.vmap(one)
    per_ray = jax.vmap(per_layer)
    return per_ray(cg.u, cg.T_sp, cg.p_sp)


def lut_fingerprint(nu_grid, lines: DeviceLines, **lattice) -> str:
    """Content hash keying a persisted LUT to its inputs: the staged line
    list, the wavenumber grid, and every lattice/build parameter.  A stale
    file (different lines, grid, or lattice) misses the cache and is
    rebuilt — the reference's pickle LUTs have no such guard [SURVEY.md 4.3].
    """
    h = hashlib.sha256()
    for f in ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
              "delta_air", "mass_amu", "species_idx", "level_upper",
              "level_lower", "nu_ref"):
        h.update(np.ascontiguousarray(np.asarray(getattr(lines, f))).tobytes())
    h.update(np.ascontiguousarray(np.asarray(nu_grid)).tobytes())
    for k in sorted(lattice):
        h.update(f"{k}={lattice[k]!r};".encode())
    return h.hexdigest()


def save_lut(lut: OpacityLUT, path: str, fingerprint: str = "") -> None:
    np.savez_compressed(path, nu_grid=np.asarray(lut.nu_grid),
                        T_grid=np.asarray(lut.T_grid),
                        logp_grid=np.asarray(lut.logp_grid),
                        sigma=np.asarray(lut.sigma),
                        vmr_self=np.asarray(lut.vmr_self),
                        fingerprint=np.asarray(fingerprint))


def load_lut(path: str) -> OpacityLUT:
    with np.load(path) as z:
        return OpacityLUT(nu_grid=jnp.asarray(z["nu_grid"]),
                          T_grid=jnp.asarray(z["T_grid"]),
                          logp_grid=jnp.asarray(z["logp_grid"]),
                          sigma=jnp.asarray(z["sigma"]),
                          vmr_self=jnp.asarray(z["vmr_self"]))


def stored_fingerprint(path: str) -> str:
    """Fingerprint recorded in a persisted LUT file ('' if absent)."""
    if not os.path.exists(path):
        return ""
    with np.load(path) as z:
        return str(z["fingerprint"]) if "fingerprint" in z.files else ""


def get_or_build_lut(path: str, nu_grid, lines: DeviceLines, n_species: int,
                     *, nlte: bool = False,
                     mesh: Optional[jax.sharding.Mesh] = None, **lattice):
    """Load the LUT at ``path`` if its fingerprint matches the current
    inputs; otherwise (re)build and persist it.  Returns (lut, was_cached).
    With ``path=''`` always builds in memory (no persistence)."""
    fp = lut_fingerprint(nu_grid, lines, nlte=nlte, **lattice)
    if path and stored_fingerprint(path) == fp:
        return (load_nlte_lut(path) if nlte else load_lut(path)), True
    if nlte:
        lut = build_nlte_lut(nu_grid, lines, n_species, mesh=mesh, **lattice)
        if path:
            save_nlte_lut(lut, path, fingerprint=fp)
    else:
        lut = build_lut(nu_grid, lines, n_species, mesh=mesh, **lattice)
        if path:
            save_lut(lut, path, fingerprint=fp)
    return lut, False


# ---------------------------------------------------------------------------
# Non-LTE tier: per-level-group coefficient tables (module docstring algebra).
# ---------------------------------------------------------------------------


class NLTELUT(NamedTuple):
    """Per-level-group (T, log p) coefficient tables.

    Groups 0..S-1 are the per-species LTE groups (unmatched lines,
    ``group_level == -1``); groups S.. are the registry's vibrational levels
    in order (``group_level == level index``).
    """

    nu_grid: jnp.ndarray        # [P]
    T_grid: jnp.ndarray         # [nT] (uniform)
    logp_grid: jnp.ndarray      # [nQ] log10(p/Pa) (uniform)
    sigma_l: jnp.ndarray        # [G, nT, nQ, P]  A_l: coefficient of r_lower
    sigma_u: jnp.ndarray        # [G, nT, nQ, P]  A_u: coefficient of -r_upper
    sigma_e: jnp.ndarray        # [G, nT, nQ, P]  M:   emission coefficient of r_upper
    group_species: jnp.ndarray  # [G] int32 species row (-1 = level unused by lines)
    group_level: jnp.ndarray    # [G] int32 registry level (-1 = LTE group)
    vmr_self: jnp.ndarray       # [S] self-broadening VMR frozen at build

    @property
    def n_groups(self) -> int:
        return int(self.group_species.shape[0])


def _line_groups(lines: DeviceLines, n_species: int):
    """Host-side group assignment: lower/upper group per line, plus the
    group->species and group->level maps."""
    S = n_species
    sp = np.asarray(lines.species_idx)
    lu = np.asarray(lines.level_upper)
    lo = np.asarray(lines.level_lower)
    n_levels = int(max(lu.max(initial=-1), lo.max(initial=-1)) + 1)
    G = S + n_levels
    lower_group = np.where(lo >= 0, S + lo, sp).astype(np.int32)
    upper_group = np.where(lu >= 0, S + lu, sp).astype(np.int32)
    group_species = np.full(G, -1, dtype=np.int32)
    group_species[:S] = np.arange(S)
    group_species[upper_group[lu >= 0]] = sp[lu >= 0]
    group_species[lower_group[lo >= 0]] = sp[lo >= 0]
    group_level = np.concatenate(
        [np.full(S, -1, dtype=np.int32),
         np.arange(n_levels, dtype=np.int32)])
    return lower_group, upper_group, group_species, group_level


def build_nlte_lut(
    nu_grid: jnp.ndarray,
    lines: DeviceLines,
    n_species: int,
    T_min: float = 120.0, T_max: float = 320.0, n_T: int = 21,
    p_min: float = 1e-3, p_max: float = 2e3, n_p: int = 25,
    vmr_self: Optional[Sequence[float]] = None,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    mesh: Optional[jax.sharding.Mesh] = None,
    chi=None,
) -> NLTELUT:
    """Build the three per-group tables in ONE line sum per lattice point:
    the Voigt basis is shared across all 3G amplitude rows (one
    contraction), so the build costs the same line-shape work as the LTE
    tier regardless of the number of levels.  ``mesh`` shards the lattice
    build over devices (:func:`lut_mesh`)."""
    from spectrobot_tpu.ops.opacity import KernelLines, accumulate_jnp, line_kernel_inputs

    S = n_species
    vs = np.ones(S) if vmr_self is None else np.asarray(vmr_self, dtype=float)
    T_grid = jnp.linspace(T_min, T_max, n_T)
    logp_grid = jnp.linspace(np.log10(p_min), np.log10(p_max), n_p)
    dt = nu_grid.dtype

    lower_g, upper_g, group_species, group_level = _line_groups(lines, S)
    G = int(group_level.shape[0])
    # [G, L] one-hot masks (host-side, static).
    mask_l = jnp.asarray(lower_g[None, :] == np.arange(G)[:, None], dt)
    mask_u = jnp.asarray(upper_g[None, :] == np.arange(G)[:, None], dt)
    vs_line = jnp.asarray(vs, dt)[lines.species_idx]
    # Offset grid staged from float64 (DeviceLines f32-rebasing contract).
    nu_off = jnp.asarray(
        np.asarray(nu_grid, np.float64) - float(lines.nu_ref), dt)

    def one_point(T, logp):
        p = 10.0 ** logp
        E = jnp.exp(-C2 * lines.nu0_abs.astype(dt) / T)
        inv1mE = 1.0 / (1.0 - E)
        # Amplitude rows [3G, L]: (A_l, A_u, M) per group, one shared basis.
        w = jnp.concatenate([mask_l * inv1mE[None, :],
                             mask_u * (E * inv1mE)[None, :],
                             mask_u], axis=0)
        kl = line_kernel_inputs(lines, T, p, vs_line * p, w, chi=chi)
        out = accumulate_jnp(nu_off, kl, chunk=chunk, variant=variant,
                             cutoff_cm1=cutoff_cm1)        # [3G, P]
        return out.reshape(3, G, -1)

    tbl = _lattice_eval(one_point, T_grid, logp_grid, mesh)  # [nT, nQ, 3, G, P]
    tbl = jnp.moveaxis(tbl, (2, 3), (0, 1))       # [3, G, nT, nQ, P]
    return NLTELUT(nu_grid=nu_grid, T_grid=T_grid, logp_grid=logp_grid,
                   sigma_l=tbl[0], sigma_u=tbl[1], sigma_e=tbl[2],
                   group_species=jnp.asarray(group_species),
                   group_level=jnp.asarray(group_level),
                   vmr_self=jnp.asarray(vs, dt))


def nlte_group_ratios(lut: NLTELUT, nlte, lay_idx, T_kin) -> jnp.ndarray:
    """Population ratios r [G] for one layer: 1 for LTE groups, the
    Boltzmann-ratio of data/nlte.py for level groups (same formula as
    ``weights_for_layer``)."""
    gl = lut.group_level
    if nlte is None:
        return jnp.ones(gl.shape, lut.sigma_l.dtype)
    tv = nlte.t_vib[:, lay_idx]
    r_lvl = jnp.exp(-C2 * nlte.e_level * (1.0 / tv - 1.0 / T_kin))
    return jnp.where(gl >= 0, r_lvl[jnp.maximum(gl, 0)], 1.0)


def layer_tau_nlte_lut(lut: NLTELUT, cg, nlte=None):
    """Non-LTE per-(ray, layer) optical depths from the tables:
    (dtau, dtau_em), each [R, NL, P] — drop-in for
    :func:`spectrobot_tpu.forward.limb.layer_tau`.

    Each group interpolates at ITS species' Curtis-Godson state, then the
    group axis contracts against u[species] * r[group] (precision pinned:
    the bf16-matmul hazard of docs/ACCURACY.md applies to this einsum).
    Differentiable in cg AND in nlte.t_vib, so retrievals of vibrational
    temperatures can run against the cached tables.
    """
    R, NL, S = cg.u.shape
    gs = jnp.maximum(lut.group_species, 0)
    lay_ids = jnp.arange(NL, dtype=jnp.int32)
    interp_rows = jax.vmap(
        lambda tbl_g, T, p: _bilinear_tq(tbl_g, lut.T_grid, lut.logp_grid, T, p))

    def one(u_sp, T_sp, p_sp, T_air, lay_idx):
        T_g = T_sp[gs]
        p_g = p_sp[gs]
        u_g = u_sp[gs] * 1.0e-4                   # molec cm^-2
        r = nlte_group_ratios(lut, nlte, lay_idx, T_air).astype(u_g.dtype)
        sl = interp_rows(lut.sigma_l, T_g, p_g)   # [G, P]
        su = interp_rows(lut.sigma_u, T_g, p_g)
        se = interp_rows(lut.sigma_e, T_g, p_g)
        w = u_g * r
        dtau = jnp.einsum("g,gp->p", w, sl - su,
                          precision=jax.lax.Precision.HIGHEST)
        dtau_em = jnp.einsum("g,gp->p", w, se,
                             precision=jax.lax.Precision.HIGHEST)
        return dtau, dtau_em

    per_layer = jax.vmap(one, in_axes=(0, 0, 0, 0, 0))
    per_ray = jax.vmap(per_layer, in_axes=(0, 0, 0, 0, None))
    return per_ray(cg.u, cg.T_sp, cg.p_sp, cg.T_air, lay_ids)


def save_nlte_lut(lut: NLTELUT, path: str, fingerprint: str = "") -> None:
    np.savez_compressed(path, fingerprint=np.asarray(fingerprint),
                        **{f: np.asarray(getattr(lut, f))
                           for f in NLTELUT._fields})


def load_nlte_lut(path: str) -> NLTELUT:
    with np.load(path) as z:
        return NLTELUT(**{f: jnp.asarray(z[f]) for f in NLTELUT._fields})
