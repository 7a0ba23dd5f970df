"""Sharded (P, T) LUT runtime (C9 x C20-C22 — the last cell of the
feature x mesh matrix, round-2 review missing item 3).

The LUT tier has no line axis at all — the tables are line sums already —
so its natural decomposition is exactly two mesh axes:

* ``nu``  — the wavenumber axis of every table ([..., nT, nQ, P]) and of
  the grid: bilinear (T, log p) interpolation is pointwise in ``nu``, so
  each chip interpolates its own chunk of the tables.  No halo, no psum.
* ``ray`` — Curtis-Godson states, pure data parallelism.

The ``line`` mesh axis is redundant here (each line shard would compute
identical values); the shard_map body simply ignores it and the outputs
are replicated across it, so LUT meshes reuse the same (ray, line, nu)
mesh objects as the line-by-line paths.

Everything is differentiable (the bilinear interpolation carries T/log p
tangents), so the distributed OE/LM loop (parallel/oe.py) runs its
vmap-of-jvp Jacobian through this forward unchanged — table lookups per LM
iteration instead of line sums, the reference's ``makeLUT*`` economics
(SURVEY.md 4.3) at mesh scale.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spectrobot_tpu.forward.geometry import PathCG
from spectrobot_tpu.forward.limb import tau_radiance_epilogue
from spectrobot_tpu.ops.lut import (
    NLTELUT, OpacityLUT, layer_tau_lut, layer_tau_nlte_lut,
)


def stage_lut_sharded(mesh: Mesh, lut):
    """device_put the LUT with its mesh layout: every table sharded over
    'nu' on its wavenumber (last) axis, small coordinate arrays replicated."""
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    if isinstance(lut, NLTELUT):
        tbl = P(None, None, None, "nu")
        return lut._replace(
            nu_grid=put(lut.nu_grid, P("nu")),
            T_grid=put(lut.T_grid, P()), logp_grid=put(lut.logp_grid, P()),
            sigma_l=put(lut.sigma_l, tbl), sigma_u=put(lut.sigma_u, tbl),
            sigma_e=put(lut.sigma_e, tbl),
            group_species=put(lut.group_species, P()),
            group_level=put(lut.group_level, P()),
            vmr_self=put(lut.vmr_self, P()))
    return lut._replace(
        nu_grid=put(lut.nu_grid, P("nu")),
        T_grid=put(lut.T_grid, P()), logp_grid=put(lut.logp_grid, P()),
        sigma=put(lut.sigma, P(None, None, None, "nu")),
        vmr_self=put(lut.vmr_self, P()))


def sharded_lut_radiance_fn(
    mesh: Mesh,
    nlte_tier: bool,
    has_background: bool,
    *,
    cia_pairs: Optional[tuple] = None,
    is_limb: bool = True,
    emissivity: float = 1.0,
):
    """Build the jitted shard_map LUT radiance function.

    Returns f(lut_s, cg, nlte, I_bg, cia) -> I [R, P]; ``lut_s`` comes from
    :func:`stage_lut_sharded` (an ``OpacityLUT``, or ``NLTELUT`` with
    ``nlte_tier=True`` and the DeviceNLTE populations passed per call).
    Same shape contract as parallel.sharded: R % mesh['ray'] == 0 and
    P % mesh['nu'] == 0.
    """
    from spectrobot_tpu.data.nlte import DeviceNLTE
    from spectrobot_tpu.parallel.sharded import NLTE_SPECS

    lut_cls = NLTELUT if nlte_tier else OpacityLUT
    tbl_spec = P(None, None, None, "nu")
    if nlte_tier:
        lut_specs = NLTELUT(
            nu_grid=P("nu"), T_grid=P(), logp_grid=P(),
            sigma_l=tbl_spec, sigma_u=tbl_spec, sigma_e=tbl_spec,
            group_species=P(), group_level=P(), vmr_self=P())
    else:
        lut_specs = OpacityLUT(nu_grid=P("nu"), T_grid=P(), logp_grid=P(),
                               sigma=tbl_spec, vmr_self=P())

    def body(lut_arrays, u, T_sp, p_sp, ps_sp, T_air, u_air, uu_air,
             seg_layer, nlte_loc, bg_loc, cia_tab_loc, cia_tg_loc):
        lut_loc = lut_cls(*lut_arrays)
        cg_loc = PathCG(u=u, T_sp=T_sp, p_sp=p_sp, p_self_sp=ps_sp,
                        T_air=T_air, seg_layer=seg_layer,
                        seg_count=int(seg_layer.shape[0]), is_limb=is_limb,
                        u_air=u_air, uu_air=uu_air)
        if nlte_tier:
            dtau, dtau_em = layer_tau_nlte_lut(lut_loc, cg_loc, nlte_loc)
        else:
            dtau = dtau_em = layer_tau_lut(lut_loc, cg_loc)
        cia_loc = None
        if cia_pairs is not None:
            from spectrobot_tpu.ops.cia import DeviceCIA
            cia_loc = DeviceCIA(tables=cia_tab_loc, T_grid=cia_tg_loc,
                                pair_a=cia_pairs[0], pair_b=cia_pairs[1])
        return tau_radiance_epilogue(lut_loc.nu_grid, cg_loc, dtau, dtau_em,
                                     cia=cia_loc, I_background=bg_loc,
                                     is_limb=is_limb, emissivity=emissivity)

    in_specs = (
        tuple(lut_specs),
        P("ray"), P("ray"), P("ray"), P("ray"), P("ray"), P("ray"),
        P("ray"), P(),
        NLTE_SPECS if nlte_tier else None,
        P("nu") if has_background else None,
        P(None, None, "nu") if cia_pairs is not None else None,
        P() if cia_pairs is not None else None,
    )
    fn = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=P("ray", "nu"), check_vma=False)
    jitted = jax.jit(fn)

    def apply(lut_s, cg: PathCG, nlte=None, I_bg=None, cia=None):
        assert (cia is not None) == (cia_pairs is not None)
        cia_tab = cia.tables if cia is not None else None
        cia_tg = cia.T_grid if cia is not None else None
        return jitted(tuple(lut_s), cg.u, cg.T_sp, cg.p_sp, cg.p_self_sp,
                      cg.T_air, cg.u_air, cg.uu_air, cg.seg_layer, nlte,
                      I_bg, cia_tab, cia_tg)

    return apply
