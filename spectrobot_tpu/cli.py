"""Command-line driver (C18, SURVEY.md call stack 4.1's entry layer).

Replaces the reference's ``spect_robot.py`` script driver with a proper CLI:

    python -m spectrobot_tpu forward  cfg.toml [-o grid.n_points=8192 ...]
    python -m spectrobot_tpu retrieve cfg.toml [...]
    python -m spectrobot_tpu info

Outputs land in ``run.output_dir``: radiances as .npz, retrieval state +
history as .npz/JSONL; stdout stays clean (diagnostics on stderr).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np


def _build_lines(cfg):
    from spectrobot_tpu.data import synth
    from spectrobot_tpu.data.hitran import LineList, parse_par_file

    src = cfg.lines.source
    if src.startswith("synthetic:"):
        gens = {
            "co2_15um": synth.co2_15um_band,
            "co2_43um": synth.co2_43um_band,
            "co2_43um_hot": synth.co2_43um_hot_band,
            "co_fundamental": synth.co_fundamental,
            "h2o": synth.h2o_band,
        }
        ll = None
        for name in src.split(":", 1)[1].split(","):
            part = gens[name.strip()]()
            ll = part if ll is None else ll.concat(part)
    elif src.endswith(".npz"):
        ll = LineList.load_npz(src)
    else:
        ll = parse_par_file(src)
    ll = ll.select(nu_min=cfg.grid.nu_min, nu_max=cfg.grid.nu_max,
                   wing_cm1=cfg.lines.wing_cm1, min_sw=cfg.lines.min_sw)
    return ll


def _build_atmosphere(cfg):
    from spectrobot_tpu.data.atmosphere import (
        PLANETS, Atmosphere, Atmosphere2D, mars_standard_atmosphere,
        mars_zonal_atmosphere, titan_standard_atmosphere,
    )

    planet = PLANETS[cfg.scene.planet.lower()]
    src = cfg.scene.atmosphere
    if src == "mars_standard":
        atm = mars_standard_atmosphere(n_lev=cfg.scene.n_levels,
                                       z_top=cfg.scene.z_top_m)
    elif src == "titan_standard":
        atm = titan_standard_atmosphere(n_lev=cfg.scene.n_levels,
                                        z_top=cfg.scene.z_top_m)
    elif src == "mars_zonal":
        atm = mars_zonal_atmosphere(n_lev=cfg.scene.n_levels,
                                    z_top=cfg.scene.z_top_m)
    else:
        with np.load(src) as z:
            is_2d = "lat_deg" in z.files
        atm = (Atmosphere2D if is_2d else Atmosphere).load_npz(src)
    if isinstance(atm, Atmosphere2D):
        # Slice the 2-D climatology at the observation latitude (reference
        # profile-class lat/alt interpolation, SURVEY.md 1.2).
        atm = atm.at_lat(cfg.scene.latitude_deg)
    return planet, atm


def _build_nlte(cfg, ll, atm, dtype):
    """Non-LTE state from config (reference call stack 4.4): registry from
    the line list's quanta, t_vib per the ``[nlte]`` section, matched level
    indices annotated IN PLACE on ``ll`` (before device staging)."""
    import numpy as np

    from spectrobot_tpu.data.nlte import (
        demo_pump_t_vib, device_nlte, lte_t_vib, match_lines_to_levels,
        registry_from_linelist, t_vib_from_npz,
    )

    reg = registry_from_linelist(ll)
    if reg.n_levels == 0:
        raise ValueError("[nlte] enabled but the line list carries no "
                         "global quanta to match levels from")
    match_lines_to_levels(ll, reg)
    z_lev = np.asarray(atm.z)
    z_mid = 0.5 * (z_lev[1:] + z_lev[:-1])
    T_lay = np.interp(z_mid, z_lev, np.asarray(atm.T))
    src = cfg.nlte.t_vib
    if not src:
        t_vib = lte_t_vib(reg, T_lay)
    elif src.startswith("demo:"):
        if src != "demo:co2_pump":
            raise KeyError(f"unknown nlte demo {src!r} (have demo:co2_pump)")
        t_vib = demo_pump_t_vib(reg, z_mid, T_lay)
    else:
        t_vib = t_vib_from_npz(reg, src, z_mid, T_lay)
    return device_nlte(reg, t_vib, dtype=dtype), reg


def build_scene(cfg):
    """Config -> (planet, atm, device_lines, nu_grid, ils_W or None, nlte)."""
    import jax.numpy as jnp
    from spectrobot_tpu.data.molparams import molecule_by_name
    from spectrobot_tpu.ops.ils import ils_matrix
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    dtype = jnp.float64 if cfg.compute.dtype == "float64" else jnp.float32
    planet, atm = _build_atmosphere(cfg)
    ll = _build_lines(cfg)
    nlte = None
    if cfg.nlte.enabled:
        nlte, _ = _build_nlte(cfg, ll, atm, dtype)
    # One species row per (mol, iso) pair ACTUALLY PRESENT in the line list
    # (expanding every registered isotopologue would multiply CG and
    # per-line work for empty rows).
    present = {(int(m), int(i)) for m, i in zip(ll.mol_id, ll.iso_id)}
    pairs = []
    for name in cfg.scene.species:
        mol = molecule_by_name(name)
        pairs.extend((mol.mol_id, iso) for iso in mol.isotopologues
                     if (mol.mol_id, iso) in present)
        if not any(p[0] == mol.mol_id for p in pairs):
            pairs.append((mol.mol_id, 1))   # keep the row (no lines yet)
    dl = device_lines_from_linelist(ll, pairs, dtype=dtype)
    # Map species rows back: rows are per (mol, iso); VMR lookup uses the
    # molecule name of each pair.
    from spectrobot_tpu.data.molparams import MOLECULES
    species_names = [MOLECULES[m].name for (m, _) in pairs]
    nu_host = np.linspace(cfg.grid.nu_min, cfg.grid.nu_max,
                          cfg.grid.n_points)
    nu = jnp.asarray(nu_host, dtype)
    # Offset grid staged from float64 (f32-precision dnu; DeviceLines doc).
    nu_off = jnp.asarray(nu_host - float(dl.nu_ref), dtype)
    W = None
    chans = np.asarray(nu_host)
    if cfg.instrument.enabled:
        lo = cfg.instrument.chan_min or cfg.grid.nu_min + 2 * cfg.instrument.fwhm_cm1
        hi = cfg.instrument.chan_max or cfg.grid.nu_max - 2 * cfg.instrument.fwhm_cm1
        chans = np.linspace(lo, hi, cfg.instrument.n_channels)
        W = jnp.asarray(ils_matrix(np.asarray(nu), chans,
                                   cfg.instrument.fwhm_cm1,
                                   cfg.instrument.shape), dtype)
    cia = _build_cia(cfg, nu, species_names, dtype) if cfg.cia.enabled else None
    return planet, atm, dl, species_names, nu, nu_off, W, chans, nlte, cia


def _build_cia(cfg, nu, species_names, dtype):
    """[cia] config -> staged DeviceCIA (or None if no pair applies)."""
    from spectrobot_tpu.ops.cia import demo_co2_cia, parse_cia_text, stage_cia

    tables = []
    for entry in cfg.cia.tables or ("demo:co2",):
        if entry == "demo:co2":
            tables.append(demo_co2_cia())
            continue
        pair, _, path = entry.partition(":")
        a, _, b = pair.partition("-")
        if not (a and b and path):
            raise ValueError(f"cia.tables entry {entry!r} is neither "
                             f"'demo:co2' nor 'A-B:<path>.cia'")
        with open(path) as f:
            tables.append(parse_cia_text(f.read(), a, b))
    staged = stage_cia(nu, tables, species_names, dtype)
    if staged is None:
        import warnings
        warnings.warn("cia.enabled is set but no table matches the scene "
                      "species — continuum is OFF for this run")
    return staged


def _check_mesh_divisibility(cfg, n_rays: int, m_ray: int, m_nu: int) -> None:
    """Config-level guard for the mesh sharding axes (one standard with the
    halo guard in parallel/halo.py:nu_shard_edges — ValueError naming the
    exact TOML keys, never a bare AssertionError reachable from a config
    file)."""
    if n_rays % m_ray != 0:
        raise ValueError(
            f"the ray count ({n_rays}, from geometry.tangent_heights_km / "
            f"geometry.sec_theta) must be divisible by compute.mesh_ray "
            f"({m_ray}); pad the ray list or change compute.mesh_ray")
    if cfg.grid.n_points % m_nu != 0:
        raise ValueError(
            f"grid.n_points ({cfg.grid.n_points}) must be divisible by "
            f"compute.mesh_nu ({m_nu}); adjust grid.n_points or "
            f"compute.mesh_nu")


def _mesh_plan(cfg):
    """(use_mesh, mesh_shape) from compute.mesh_*: engages only when the user
    EXPLICITLY sets any axis (defaults (1, 1, 0) stay single-device, so plain
    configs keep working on multi-chip hosts)."""
    import jax
    n_dev = len(jax.devices())
    m_ray, m_line = cfg.compute.mesh_ray, cfg.compute.mesh_line
    explicit = (m_ray, m_line, cfg.compute.mesh_nu) != (1, 1, 0)
    m_nu = cfg.compute.mesh_nu or max(n_dev // max(m_ray * m_line, 1), 1)
    shape = (m_ray, m_line, m_nu)
    return explicit and int(np.prod(shape)) > 1, shape


def _engine(cfg, n_lines: int) -> str:
    """Opacity engine selection — ONE policy for forward/retrieve/mesh:
    the Triton kernels on a GPU (ops.opacity.default_engine; PERF.md
    "Kernel decisions" has the measurements), the jnp/XLA reference
    elsewhere or when ``compute.use_pallas`` is off.  The ``n_lines``
    parameter stays so a measured line-count crossover can be added
    without touching call sites."""
    from spectrobot_tpu.ops.opacity import default_engine
    del n_lines
    return ("pallas" if cfg.compute.use_pallas
            and cfg.compute.variant == "humlicek4"
            and default_engine() == "pallas" else "jnp")


def _build_chi(cfg, species_names):
    """[lines] chi -> (ChiProfile, per-species-row apply mask) or None."""
    name = cfg.lines.chi
    if not name:
        return None
    from spectrobot_tpu.ops.chi import CHI_PROFILES
    if name not in CHI_PROFILES:
        raise KeyError(f"unknown lines.chi profile {name!r}; available: "
                       f"{sorted(CHI_PROFILES)}")
    prof = CHI_PROFILES[name]
    mask = tuple(s.upper() == prof.species.upper() for s in species_names)
    if not any(mask):
        import warnings
        warnings.warn(f"lines.chi = {name!r} applies to {prof.species} but "
                      f"the scene species are {species_names} — chi is a "
                      f"no-op for this run")
    return (prof, mask)


def _build_fov(cfg, dtype):
    """[instrument] FOV smearing (C14's second half, round-2 review
    item 7): returns (ray tangent heights [m], fov_V or None).  With
    ``fov_fwhm_km > 0`` the forward runs on a FINE ladder of ``fov_n_fine``
    rays spanning the observed tangent heights +- 2 FWHM; fov_V smears the
    ladder into the observed FOVs."""
    import jax.numpy as jnp

    h_obs_km = np.asarray(cfg.geometry.tangent_heights_km, float)
    fwhm_km = cfg.instrument.fov_fwhm_km
    if fwhm_km <= 0 or cfg.geometry.mode != "limb":
        return jnp.asarray(h_obs_km * 1e3, dtype), None
    from spectrobot_tpu.ops.ils import fov_matrix
    n = cfg.instrument.fov_n_fine
    lo = max(float(h_obs_km.min()) - 2.0 * fwhm_km, 0.0)
    hi = float(h_obs_km.max()) + 2.0 * fwhm_km
    h_fine_km = np.linspace(lo, hi, n)
    V = jnp.asarray(fov_matrix(h_fine_km * 1e3, h_obs_km * 1e3,
                               fwhm_km * 1e3, cfg.instrument.fov_shape),
                    dtype)
    return jnp.asarray(h_fine_km * 1e3, dtype), V


def _get_lut(cfg, nu, dl, species_names, atm, nlte, chi=None):
    """Build or load the (P, T) LUT for the configured scene (shared by
    forward and retrieve — round-2 review item 4: ``compute.use_lut``
    must be honoured in BOTH).  Returns (lut, source_description)."""
    import jax
    from spectrobot_tpu.ops.lut import get_or_build_lut, lut_mesh

    # Self-broadening VMRs frozen at the surface value of each species row.
    vs = [float(atm.vmr[n_][0]) for n_ in species_names]
    T_arr = np.asarray(atm.T)
    p_arr = np.asarray(atm.p)
    lattice = dict(
        T_min=max(80.0, float(T_arr.min()) - 30.0),
        T_max=float(T_arr.max()) + 30.0, n_T=cfg.compute.lut_n_T,
        p_min=max(float(p_arr.min()) * 0.5, 1e-6),
        p_max=float(p_arr.max()) * 2.0, n_p=cfg.compute.lut_n_p,
        variant=cfg.compute.variant,
        cutoff_cm1=cfg.compute.cutoff_cm1, chunk=cfg.compute.chunk,
        chi=chi)
    mesh = lut_mesh() if cfg.compute.lut_build_mesh else None
    lut, cached = get_or_build_lut(
        cfg.compute.lut_path, nu, dl, len(species_names),
        nlte=nlte is not None, mesh=mesh, vmr_self=vs, **lattice)
    src = ("cached " + cfg.compute.lut_path if cached else
           ("built on %d-device mesh" % len(jax.devices()) if mesh
            else "built"))
    return lut, src


def cmd_forward(cfg) -> dict:
    import jax
    import jax.numpy as jnp
    from spectrobot_tpu.forward.geometry import limb_path_cg, nadir_path_cg
    from spectrobot_tpu.ops.ils import apply_fov, apply_ils

    (planet, atm, dl, species_names, nu, nu_off, W, _chans, nlte,
     cia) = build_scene(cfg)
    # ONE engine policy (round-3 review weak item 2): the single-device forward
    # honours the same measured selection as retrieve and the mesh path.
    use_pallas = _engine(cfg, dl.n_lines) == "pallas"
    is_limb = cfg.geometry.mode == "limb"
    h_t, fov_V = _build_fov(cfg, nu.dtype)        # limb rays (fine if FOV)
    sec = jnp.asarray(cfg.geometry.sec_theta, nu.dtype)
    emis = cfg.geometry.emissivity

    # Mesh path (C20-C23).
    use_mesh, mesh_shape = _mesh_plan(cfg)
    m_ray, m_line, m_nu = mesh_shape
    chi = _build_chi(cfg, species_names)
    if cfg.run.save_optics and (use_mesh or cfg.compute.use_lut):
        # The optics tap rides the single-device line-by-line branch (it
        # reuses that branch's raw depths); refuse loudly rather than
        # silently skipping the requested output.
        raise ValueError(
            "run.save_optics currently requires the single-device "
            "line-by-line forward — disable compute.mesh_* and "
            "compute.use_lut, or drop run.save_optics")
    t0 = time.time()
    if use_mesh and cfg.compute.use_lut:
        # LUT x mesh (parallel/sharded_lut.py): tables shard over 'nu',
        # Curtis-Godson states over 'ray'; no line axis exists.
        from spectrobot_tpu.parallel.mesh import make_mesh
        from spectrobot_tpu.parallel.sharded_lut import (
            sharded_lut_radiance_fn, stage_lut_sharded,
        )
        n_rays = int(h_t.shape[0]) if is_limb else int(sec.shape[0])
        _check_mesh_divisibility(cfg, n_rays, m_ray, m_nu)
        mesh = make_mesh(mesh_shape)
        lut, src = _get_lut(cfg, nu, dl, species_names, atm, nlte, chi=chi)
        if is_limb:
            cg = limb_path_cg(atm, species_names, h_t, planet,
                              cfg.geometry.n_sub)
            I_bg = None
        else:
            from spectrobot_tpu.ops.planck import planck_nu
            cg = nadir_path_cg(atm, species_names, sec, cfg.geometry.n_sub)
            I_bg = emis * planck_nu(nu, cfg.geometry.t_surface)
        f = sharded_lut_radiance_fn(
            mesh, nlte_tier=nlte is not None, has_background=not is_limb,
            cia_pairs=(None if cia is None else (cia.pair_a, cia.pair_b)),
            is_limb=is_limb, emissivity=emis)
        I = f(stage_lut_sharded(mesh, lut), cg, nlte, I_bg=I_bg, cia=cia)
        print(f"mesh LUT forward over "
              f"{dict(zip(('ray', 'line', 'nu'), mesh_shape))} ({src})",
              file=sys.stderr)
    elif use_mesh:
        from spectrobot_tpu.parallel.mesh import make_mesh
        from spectrobot_tpu.parallel.sharded import (
            pad_lines_for_mesh, partition_lines_by_nu, sharded_radiance_fn,
            stage_sharded,
        )
        n_rays = int(h_t.shape[0]) if is_limb else int(sec.shape[0])
        _check_mesh_divisibility(cfg, n_rays, m_ray, m_nu)
        mesh = make_mesh(mesh_shape)
        if cfg.compute.mesh_halo:
            dlp = partition_lines_by_nu(dl, np.asarray(nu), m_nu,
                                        cutoff_cm1=cfg.compute.cutoff_cm1,
                                        line_shards=m_line)
        else:
            dlp = pad_lines_for_mesh(dl, m_line)
        engine = _engine(cfg, dl.n_lines)
        if is_limb:
            cg = limb_path_cg(atm, species_names, h_t, planet,
                              cfg.geometry.n_sub)
            I_bg = None
        else:
            from spectrobot_tpu.ops.planck import planck_nu
            cg = nadir_path_cg(atm, species_names, sec, cfg.geometry.n_sub)
            I_bg = emis * planck_nu(nu, cfg.geometry.t_surface)
        f = sharded_radiance_fn(mesh, has_nlte=nlte is not None,
                                has_background=not is_limb,
                                variant=cfg.compute.variant,
                                cutoff_cm1=cfg.compute.cutoff_cm1,
                                chunk=cfg.compute.chunk, engine=engine,
                                nu_halo=cfg.compute.mesh_halo, chi=chi,
                                cia_pairs=(None if cia is None else
                                           (cia.pair_a, cia.pair_b)),
                                is_limb=is_limb, emissivity=emis,
                                win_grid=(np.asarray(nu_off)
                                          if engine == "pallas" else None),
                                win_lines=(np.asarray(dlp.nu0)
                                           if engine == "pallas" else None))
        staged = stage_sharded(mesh, nu, dlp, cg, nlte=nlte, I_bg=I_bg,
                               cia=cia)
        nu_s, lines_s, cg_s, nlte_s, bg_s = staged[:5]
        cia_s = staged[5] if cia is not None else None
        I = f(nu_s, lines_s, cg_s, nlte_s, bg_s, nu_off=nu_off, cia=cia_s)
        print(f"mesh forward over {dict(zip(('ray','line','nu'), mesh_shape))}"
              f" engine={engine}"
              f"{' nu-halo' if cfg.compute.mesh_halo else ''}",
              file=sys.stderr)
    elif cfg.compute.use_lut:
        # C9 LUT runtime (reference call stack 4.3): build once, interpolate
        # per (ray, layer) instead of re-summing lines.  Non-LTE scenes use
        # the per-level-group tier (ops/lut.py NLTELUT).
        from spectrobot_tpu.forward.limb import radiance_from_tau
        from spectrobot_tpu.ops.lut import layer_tau_lut, layer_tau_nlte_lut
        lut, src = _get_lut(cfg, nu, dl, species_names, atm, nlte, chi=chi)
        if is_limb:
            cg = limb_path_cg(atm, species_names, h_t, planet,
                              cfg.geometry.n_sub)
            ts = None
        else:
            cg = nadir_path_cg(atm, species_names, sec, cfg.geometry.n_sub)
            ts = cfg.geometry.t_surface
        if nlte is not None:
            dtau, dtau_em = layer_tau_nlte_lut(lut, cg, nlte)
            print(f"LUT runtime forward (non-LTE per-level tables, {src})",
                  file=sys.stderr)
        else:
            dtau = dtau_em = layer_tau_lut(lut, cg)
            print(f"LUT runtime forward (LTE, {src})", file=sys.stderr)
        I = jax.jit(lambda d, de: radiance_from_tau(
            nu, cg, d, de, cia=cia, T_surface=ts,
            emissivity=emis))(dtau, dtau_em)
    else:
        # Single-device line-by-line path, restructured (round 4) around
        # ONE (ray x layer) line sum: the raw depths feed the SHARED
        # radiance epilogue (identical math to limb_radiance /
        # nadir_radiance / limb_radiance_pallas — same tau_radiance_epilogue
        # serves the mesh bodies), and [run] save_optics reuses the SAME
        # depths for per-ray LOS optical-depth/transmittance output at no
        # extra line-sum cost (the reference's SpectralObject family).
        from spectrobot_tpu.forward.limb import (
            layer_tau, layer_tau_pallas, radiance_from_tau)
        if is_limb:
            cg = limb_path_cg(atm, species_names, h_t, planet,
                              cfg.geometry.n_sub)
            t_surf = None
        else:
            cg = nadir_path_cg(atm, species_names, sec, cfg.geometry.n_sub)
            t_surf = cfg.geometry.t_surface
        if use_pallas:
            dtau, dtau_em = layer_tau_pallas(
                nu, dl, cg, nlte, cutoff_cm1=cfg.compute.cutoff_cm1,
                nu_off=nu_off, chi=chi)
        else:
            dtau, dtau_em = jax.jit(lambda: layer_tau(
                nu, dl, cg, nlte, variant=cfg.compute.variant,
                cutoff_cm1=cfg.compute.cutoff_cm1, chunk=cfg.compute.chunk,
                nu_off=nu_off, chi=chi))()
        # radiance_from_tau owns the limb/nadir + grey-surface dispatch —
        # the same shared tail the LUT branch uses (round-4 review: one
        # place for the surface convention, not two).
        I = jax.jit(lambda d, de: radiance_from_tau(
            nu.astype(d.dtype), cg, d, de, cia=cia, T_surface=t_surf,
            emissivity=emis))(dtau, dtau_em)
        if cfg.run.save_optics:
            from spectrobot_tpu.ops.cia import cia_dtau
            from spectrobot_tpu.spectra import optical_depth as _tau_spectrum

            def _los_tau(d):
                if cia is not None:
                    d = d + cia_dtau(cia, cg).astype(d.dtype)
                return d[:, cg.seg_layer, :].sum(axis=1)

            tau_los = np.asarray(jax.jit(_los_tau)(dtau))
            sp_tau = _tau_spectrum(np.asarray(nu, np.float64), tau_los)
            optics_path = os.path.join(cfg.run.output_dir, "optics.npz")
            os.makedirs(cfg.run.output_dir, exist_ok=True)
            sp_tau.save_npz(optics_path, transmittance=np.exp(-tau_los))
            print(f"optics: LOS tau + transmittance -> {optics_path}",
                  file=sys.stderr)
    if fov_V is not None:
        I = apply_fov(I, fov_V)
    if W is not None:
        I = apply_ils(I, W)
    I = np.asarray(jax.block_until_ready(I))
    wall = time.time() - t0

    os.makedirs(cfg.run.output_dir, exist_ok=True)
    out_path = os.path.join(cfg.run.output_dir, "forward.npz")
    # Emit through the Spectrum family (the reference's user-facing
    # SpectralObject currency, SURVEY.md 1.2) so forward.npz carries the
    # CORRECT output axis + units: after ILS channelisation the spectral
    # axis is the instrument channel centers, not the fine grid (round-4
    # fix — the old writer paired channelised radiances with the fine nu).
    from spectrobot_tpu.spectra import radiance as _radiance_spectrum
    out_grid = np.asarray(_chans if W is not None else nu, np.float64)
    sp = _radiance_spectrum(out_grid, I)
    extra = {"tangent_heights_km": np.asarray(
        cfg.geometry.tangent_heights_km)}
    if W is not None:
        extra["nu_fine"] = np.asarray(nu)      # the monochromatic grid
    sp.save_npz(out_path, radiance=I, **extra)  # 'radiance' = compat alias
    try:
        from spectrobot_tpu.utils.plots import plot_radiances
        labels = ([f"{h:.1f} km" for h in cfg.geometry.tangent_heights_km]
                  if is_limb else
                  [f"sec={s_:.2f}" for s_ in cfg.geometry.sec_theta])
        plot_radiances(os.path.join(cfg.run.output_dir, "forward.png"),
                       np.asarray(sp.nu), np.asarray(sp.values),
                       labels=labels if len(labels) == I.shape[0] else None,
                       title=f"{cfg.geometry.mode} {sp.kind} [{sp.units}]")
    except Exception as e:  # plotting must never fail a forward
        print(f"plotting skipped: {e}", file=sys.stderr)
    print(f"forward: {I.shape} radiances in {wall:.2f}s -> {out_path}",
          file=sys.stderr)
    return {"radiance_shape": list(I.shape), "wall_s": wall,
            "output": out_path, "n_lines": dl.n_lines,
            "engine": "lut" if cfg.compute.use_lut
            else _engine(cfg, dl.n_lines)}


def _check_obs_consistency(cfg, obs, chans, n_chan):
    """A loaded observation must match the CONFIGURED forward geometry and
    channel grid — a silent mismatch would fit real data with the wrong
    forward model, so every discrepancy names the config key to fix."""
    if cfg.geometry.mode == "limb":
        got = (None if obs.tangent_heights_m is None
               else np.asarray(obs.tangent_heights_m) / 1e3)
        want = np.asarray(cfg.geometry.tangent_heights_km, dtype=float)
        what = "geometry.tangent_heights_km"
    else:
        got = None if obs.sec_theta is None else np.asarray(obs.sec_theta)
        want = np.asarray(cfg.geometry.sec_theta, dtype=float)
        what = "geometry.sec_theta"
    if got is not None and (got.shape != want.shape
                            or not np.allclose(got, want, rtol=1e-6)):
        raise ValueError(
            f"observation file {cfg.retrieval.obs_path!r} has "
            f"{what.split('.')[1]} {np.round(got, 3).tolist()} but the "
            f"config requests {want.tolist()} — set {what} to match the "
            f"file (the forward model is built from the config)")
    if obs.n_chan != n_chan or not np.allclose(
            np.asarray(obs.nu_channels), np.asarray(chans), rtol=0, atol=1e-6):
        raise ValueError(
            f"observation file {cfg.retrieval.obs_path!r} has {obs.n_chan} "
            f"channels on [{float(obs.nu_channels[0]):.3f}, "
            f"{float(obs.nu_channels[-1]):.3f}] cm-1 but the configured "
            f"instrument produces {n_chan} on [{float(chans[0]):.3f}, "
            f"{float(chans[-1]):.3f}] — adjust instrument.n_channels / "
            f"chan_min / chan_max (or grid.*) to match the file")


def _make_jacobian(cfg, fwd_flat, x0, nu, W, h_t):
    """Jacobian callable with the HBM memory guard (round-1 review item 9):
    plain ``jacfwd`` carries an (n_x x n_y)-sized tangent batch through the
    line sum — fine for small retrievals, >100 GB at scale (README).  Above
    a working-set threshold (or when retrieval.jac_chunk > 0) switch to
    ``jacobian_fwd_chunked``, which bounds the live tangent batch."""
    import jax
    from spectrobot_tpu.retrieval.state import jacobian_fwd_chunked

    n_x = int(np.asarray(x0).shape[0])
    n_ray = int(h_t.shape[0]) if h_t is not None else len(cfg.geometry.sec_theta)
    n_fine = int(nu.shape[0])
    chunk = cfg.retrieval.jac_chunk
    if chunk == 0:
        # Auto: the tangent batch peaks at ~n_x x n_ray x n_layers x n_fine
        # floats inside the per-layer line sums; cap the estimate at ~8 GB
        # of f32 before chunking to 16 columns.
        n_lay = cfg.scene.n_levels - 1
        est_bytes = 4.0 * n_x * n_ray * n_lay * n_fine
        chunk = 16 if est_bytes > 8e9 else None
    if chunk:
        import sys as _sys
        print(f"jacobian: chunked forward-mode ({chunk} tangent columns)",
              file=_sys.stderr)
        return jax.jit(lambda x: jacobian_fwd_chunked(fwd_flat, x,
                                                      chunk=int(chunk)))
    return jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))


def cmd_retrieve(cfg, y_obs: Optional[np.ndarray] = None) -> dict:
    import jax
    import jax.numpy as jnp
    from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
    from spectrobot_tpu.retrieval.state import (
        build_forward, flatten_state, make_state,
    )
    from spectrobot_tpu.utils.checkpoint import Checkpointer
    from spectrobot_tpu.utils.runlog import RunLogger

    (planet, atm, dl, species_names, nu, nu_off, W, chans, nlte,
     cia) = build_scene(cfg)
    is_limb = cfg.geometry.mode == "limb"
    h_t, fov_V = (_build_fov(cfg, nu.dtype) if is_limb else (None, None))
    sec = (None if is_limb
           else jnp.asarray(cfg.geometry.sec_theta, nu.dtype))
    emis = cfg.geometry.emissivity
    # Engine selection: see _engine.
    engine = _engine(cfg, dl.n_lines)

    chi = _build_chi(cfg, species_names)
    retrieve_vmr = list(cfg.retrieval.retrieve_vmr)
    ret_T = cfg.retrieval.retrieve_temperature
    if not ret_T and not retrieve_vmr:
        raise ValueError("nothing to retrieve: enable "
                         "retrieval.retrieve_temperature or list species in "
                         "retrieval.retrieve_vmr")
    state0 = make_state(atm, retrieve_vmr, retrieve_temperature=ret_T)
    # Coarse node-grid parameter basis (reference bayes-set node grids;
    # retrieval.n_nodes / retrieval.node_alt_km): the state lives on the
    # nodes; a static linear map expands it to model levels inside the
    # forward, so Jacobian columns shrink to the node count.
    nb = None
    if cfg.retrieval.node_alt_km or cfg.retrieval.n_nodes:
        from spectrobot_tpu.retrieval.state import NodeBasis
        if cfg.retrieval.node_alt_km:
            # Accept TOML float lists and "-o retrieval.node_alt_km=[a,b]"
            # override strings (the generic tuple override keeps strings).
            node_km = [float(str(v).strip("[] "))
                       for v in cfg.retrieval.node_alt_km]
            nb = NodeBasis(np.asarray(atm.z),
                           np.asarray(node_km, np.float64) * 1e3)
        else:
            if cfg.retrieval.n_nodes < 2:
                raise ValueError(
                    f"retrieval.n_nodes ({cfg.retrieval.n_nodes}) must be "
                    f">= 2 (or 0 to retrieve at every model level)")
            nb = NodeBasis.uniform(atm, cfg.retrieval.n_nodes)
        state0 = nb.init_state(atm, retrieve_vmr, retrieve_temperature=ret_T)
        print(f"retrieving on {nb.n_nodes} altitude nodes "
              f"({nb.z_nodes[0] / 1e3:.1f}-{nb.z_nodes[-1] / 1e3:.1f} km) "
              f"mapped to {atm.n_lev} levels", file=sys.stderr)
    expand = nb.expand if nb is not None else (lambda s: s)
    x0, unravel = flatten_state(state0)

    use_mesh, mesh_shape = _mesh_plan(cfg)
    oe_sharded = None
    if use_mesh:
        # Distributed retrieval (C26 + C16, parallel/oe.py): sharded forward,
        # psum-assembled normal equations per LM iteration, all_gather
        # Jacobian for the posterior diagnostics.
        from spectrobot_tpu.parallel.mesh import make_mesh
        from spectrobot_tpu.parallel.oe import make_sharded_oe
        m_ray, m_line, m_nu = mesh_shape
        n_rays = int(h_t.shape[0]) if is_limb else int(sec.shape[0])
        _check_mesh_divisibility(cfg, n_rays, m_ray, m_nu)
        mesh = make_mesh(mesh_shape)
        lut = None
        if cfg.compute.use_lut:
            # LUT x mesh retrieval: tables shard over 'nu'; each LM
            # iteration costs bilinear lookups, not line sums.
            lut, lut_src = _get_lut(cfg, nu, dl, species_names, atm, nlte, chi=chi)
        oe_sharded = make_sharded_oe(
            mesh, atm, dl, nu, species_names, planet, h_t,
            state_template=state0, ils_W=W, fov_V=fov_V, nlte=nlte,
            state_map=(nb.expand if nb is not None else None), chi=chi,
            n_sub=cfg.geometry.n_sub, variant=cfg.compute.variant,
            cutoff_cm1=cfg.compute.cutoff_cm1, chunk=cfg.compute.chunk,
            nu_off=nu_off, engine=engine, nu_halo=cfg.compute.mesh_halo,
            cia=cia, sec_theta=sec, T_surface=cfg.geometry.t_surface,
            emissivity=emis, lut=lut)
        fwd_flat, jac = oe_sharded.forward_flat, oe_sharded.jacobian
        print(f"mesh retrieval over "
              f"{dict(zip(('ray', 'line', 'nu'), mesh_shape))} "
              + (f"LUT tier ({lut_src})" if lut is not None else
                 f"engine={engine}"
                 f"{' nu-halo' if cfg.compute.mesh_halo else ''}"),
              file=sys.stderr)
    elif cfg.compute.use_lut:
        # LUT runtime retrieval (round-2 review item 4: the reference
        # builds LUTs precisely to make retrieval loops cheap, SURVEY.md
        # 4.3; the bilinear interpolation is differentiable so jacfwd works
        # unchanged).  The table is built ONCE outside the LM loop.
        from spectrobot_tpu.retrieval.state import build_forward_lut
        lut, src = _get_lut(cfg, nu, dl, species_names, atm, nlte, chi=chi)
        fwd = build_forward_lut(
            atm, lut, species_names, planet, tangent_heights_m=h_t,
            sec_theta=sec, T_surface=cfg.geometry.t_surface,
            emissivity=emis, ils_W=W, fov_V=fov_V, nlte=nlte,
            n_sub=cfg.geometry.n_sub, cia=cia)
        fwd_flat = jax.jit(lambda x: fwd(expand(unravel(x))))
        jac = _make_jacobian(cfg, fwd_flat, x0, nu, W, h_t)
        print(f"LUT runtime retrieval ({src})", file=sys.stderr)
    else:
        fwd = build_forward(
            atm, dl, nu, species_names, planet, tangent_heights_m=h_t,
            sec_theta=sec, T_surface=cfg.geometry.t_surface,
            emissivity=emis, ils_W=W,
            fov_V=fov_V, nlte=nlte, n_sub=cfg.geometry.n_sub,
            variant=cfg.compute.variant,
            cutoff_cm1=cfg.compute.cutoff_cm1, chunk=cfg.compute.chunk,
            nu_off=nu_off, engine=engine, cia=cia, chi=chi)
        fwd_flat = jax.jit(lambda x: fwd(expand(unravel(x))))
        jac = _make_jacobian(cfg, fwd_flat, x0, nu, W, h_t)

    n_lev = atm.n_lev
    # Prior blocks in ravel_pytree's flat order: "T" (sorted before
    # "ln_vmr"), then the VMR profiles by SORTED species name.  Each block
    # is one profile of the parameter basis: model levels, or the coarse
    # node grid when retrieval.n_nodes/node_alt_km is set.
    n_par = nb.n_nodes if nb is not None else n_lev
    blocks = ([np.full(n_par, cfg.retrieval.sigma_T ** 2)] if ret_T else [])
    blocks += [np.full(n_par, cfg.retrieval.sigma_lnvmr ** 2)
               for _ in sorted(retrieve_vmr)]
    sa = np.concatenate(blocks)
    S_a = np.diag(sa)

    from spectrobot_tpu.retrieval.obs import Observation

    n_chan = (W.shape[0] if W is not None else nu.shape[0])
    if y_obs is not None:
        noise = cfg.instrument.noise or 0.005 * float(np.max(y_obs))
        n_ray = (len(cfg.geometry.tangent_heights_km)
                 if cfg.geometry.mode == "limb" else len(cfg.geometry.sec_theta))
        obs = Observation.synthesize(np.asarray(y_obs).reshape(n_ray, n_chan),
                                     chans, 0.0)
        obs.sigma[:] = noise
    elif cfg.retrieval.obs_path:
        # .npz round-trip or campaign-style text table (obs.load_table).
        obs = Observation.load(cfg.retrieval.obs_path)
        _check_obs_consistency(cfg, obs, chans, n_chan)
    else:
        # Self-test mode: synthesise observations from a truth that perturbs
        # every retrieved quantity.
        atm_true = atm
        if ret_T:
            atm_true = atm_true.with_temperature(
                atm.T + jnp.asarray(5.0 * np.sin(np.linspace(0, 3, n_lev)),
                                    atm.T.dtype))
        for s in retrieve_vmr:
            atm_true = atm_true.with_vmr(
                s, atm.vmr[s] * jnp.asarray(
                    np.exp(0.3 * np.sin(np.linspace(0.5, 2.5, n_lev))),
                    atm.T.dtype))
        x_true, _ = flatten_state(
            nb.init_state(atm_true, retrieve_vmr, retrieve_temperature=ret_T)
            if nb is not None else
            make_state(atm_true, retrieve_vmr, retrieve_temperature=ret_T))
        y_clean = np.asarray(fwd_flat(jnp.asarray(x_true)))
        noise = cfg.instrument.noise or 0.005 * float(y_clean.max())
        n_ray = (len(cfg.geometry.tangent_heights_km)
                 if cfg.geometry.mode == "limb" else len(cfg.geometry.sec_theta))
        obs = Observation.synthesize(y_clean.reshape(n_ray, n_chan), chans,
                                     noise, seed=0)
    if cfg.retrieval.windows:
        obs = obs.with_windows(cfg.retrieval.windows)
    y_obs, noise_flat = obs.flattened()

    os.makedirs(cfg.run.output_dir, exist_ok=True)
    log_path = cfg.run.log_file or os.path.join(cfg.run.output_dir, "run.jsonl")
    ck_dir = cfg.run.checkpoint_dir or os.path.join(cfg.run.output_dir, "ck")
    logger = RunLogger(log_path, echo=True)
    normal_eqs = None
    if oe_sharded is not None:
        oe_sharded.bind_observation(y_obs, noise_flat)
        normal_eqs = oe_sharded.normal_eqs
    state_check = None
    if ret_T:
        from spectrobot_tpu.data import tips

        def state_check(x, _lo=float(tips.T_GRID[0]),
                        _hi=float(tips.T_GRID[-1])):
            # The T block leads the flat state (ravel_pytree key order);
            # with a node basis the expansion is convex, so node bounds
            # bound the expanded level profile too.
            T = np.asarray(x[:n_par])
            if T.min() < _lo or T.max() > _hi:
                return (f"retrieved temperature "
                        f"[{T.min():.0f}, {T.max():.0f}] K left the "
                        f"partition-sum table range [{_lo:.0f}, {_hi:.0f}] K"
                        f" — Q(T) is CLAMPED there; tighten the prior "
                        f"(retrieval.sigma_T) or check the observations")
            return None

    res = retrieve(
        fwd_flat, jac, jnp.asarray(y_obs), x0, x0, S_a,
        jnp.asarray(noise_flat),
        OEConfig(max_iter=cfg.retrieval.max_iter,
                 lm_lambda0=cfg.retrieval.lm_lambda0,
                 chi2_rel_tol=cfg.retrieval.chi2_rel_tol),
        logger=logger, checkpointer=Checkpointer(ck_dir),
        normal_eqs=normal_eqs, state_check=state_check)

    # Fitted spectrum at the solution (one extra forward) — what the
    # reference's users compare against the observations first.
    y_fit = np.asarray(fwd_flat(jnp.asarray(res.x, x0.dtype)))
    out_path = os.path.join(cfg.run.output_dir, "retrieval.npz")
    # Same output currency as forward.npz (round-4 review weak item 6): the
    # fitted spectrum goes through the Spectrum family, so retrieval.npz
    # carries nu/values/kind/units with the channel axis; the retrieval
    # arrays and the old raw keys (y_fit/channels_cm1) ride as extras.
    from spectrobot_tpu.spectra import radiance as _radiance_spectrum
    sp_fit = _radiance_spectrum(np.asarray(chans, np.float64),
                                y_fit.reshape(-1, n_chan))
    sp_fit.save_npz(
        out_path, x=res.x, S_hat=res.S_hat, A_kernel=res.A_kernel,
        chi2=res.chi2, n_iter=res.n_iter, converged=res.converged,
        stop_reason=np.asarray(res.stop_reason),
        y_fit=y_fit.reshape(-1, n_chan),           # compat alias of values
        y_obs=np.asarray(y_obs).reshape(-1, n_chan),
        noise=np.asarray(noise_flat).reshape(-1, n_chan),
        channels_cm1=np.asarray(chans))            # compat alias of nu
    try:
        from spectrobot_tpu.utils.plots import (
            plot_averaging_kernels, plot_fit, plot_retrieval,
        )
        plot_fit(os.path.join(cfg.run.output_dir, "fit.png"),
                 np.asarray(chans), np.asarray(y_obs).reshape(-1, n_chan),
                 y_fit.reshape(-1, n_chan),
                 np.asarray(noise_flat).reshape(-1, n_chan))
        z_m = (np.asarray(atm.z) if nb is None else
               np.asarray(nb.z_nodes))       # the basis altitudes
        if ret_T:
            sig = np.sqrt(np.maximum(np.diag(res.S_hat)[:n_par], 0.0))
            plot_retrieval(
                os.path.join(cfg.run.output_dir, "retrieval_T.png"),
                z_m, res.x[:n_par], np.asarray(x0)[:n_par], T_sigma=sig)
        plot_averaging_kernels(
            os.path.join(cfg.run.output_dir, "averaging_kernels.png"),
            z_m, res.A_kernel, min(n_par, res.A_kernel.shape[0]))
    except Exception as e:  # plotting must never fail a retrieval
        print(f"plotting skipped: {e}", file=sys.stderr)
    # Honest convergence reporting (round-2 review weak item 7):
    # distinguish "hit the iteration budget with chi2 still improving" from
    # a genuinely failed/stalled fit.
    if res.converged:
        status = f"converged ({res.stop_reason})"
    elif res.stop_reason == "max_iter":
        improving = bool(res.history and res.history[-1].get("accepted"))
        status = ("hit retrieval.max_iter with chi2 still improving — raise "
                  "max_iter to converge" if improving
                  else "hit retrieval.max_iter")
    else:
        status = ("LM stalled (lambda exceeded lambda_max — no damping "
                  "produced an acceptable step)")
    print(f"retrieve: {status}; n_iter={res.n_iter} "
          f"chi2={res.chi2:.4g} -> {out_path}", file=sys.stderr)
    return {"converged": bool(res.converged), "stop_reason": res.stop_reason,
            "status": status, "n_iter": res.n_iter,
            "chi2": float(res.chi2), "output": out_path}


def cmd_info() -> dict:
    import jax
    from spectrobot_tpu.config import Config
    from spectrobot_tpu.data import hitran_native
    from spectrobot_tpu.data.molparams import MOLECULES
    devs = jax.devices()
    info = {
        "version": __import__("spectrobot_tpu").__version__,
        "jax": jax.__version__,
        "devices": [f"{d.device_kind} ({d.platform})" for d in devs],
        "default_engine": _engine(Config(), 0),
        "native_parser_built": hitran_native.available(),
        "molecules_registered": len(MOLECULES),
        "isotopologues_registered": sum(len(m.isotopologues)
                                        for m in MOLECULES.values()),
    }
    return info


def enable_compile_cache() -> str:
    """Persistent compile cache: the directory ``JAX_COMPILATION_CACHE_DIR``
    names when it is set, else ``<checkout>/.jax_cache``.  Returns the
    directory in use."""
    import jax
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache)
    # Cache every program: CPU compiles of many small ops add up too.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache


def main(argv=None) -> int:
    from spectrobot_tpu.config import load_config

    enable_compile_cache()

    p = argparse.ArgumentParser(prog="spectrobot_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("forward", "retrieve"):
        sp = sub.add_parser(name)
        sp.add_argument("config", nargs="?", default=None)
        sp.add_argument("-o", "--override", action="append", default=[],
                        metavar="SECTION.KEY=VALUE")
    sub.add_parser("info")
    args = p.parse_args(argv)

    if args.cmd == "info":
        print(json.dumps(cmd_info(), indent=2))
        return 0

    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = v
    cfg = load_config(args.config, overrides)
    result = cmd_forward(cfg) if args.cmd == "forward" else cmd_retrieve(cfg)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
