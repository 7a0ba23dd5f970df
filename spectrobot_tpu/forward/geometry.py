"""Line-of-sight geometry + Curtis-Godson averaging (C11/C12, SURVEY.md).

The reference (fedef17/SpectRobot ``spect_base/spect_main`` [SURVEY.md 1.2])
builds limb/nadir paths with Python loops.  Design: closed-form
chord lengths through spherical shells,

    l(r) = sqrt(max(r^2 - r_t^2, 0)),   ds_layer = l(r_top) - l(r_bot),

evaluated as static-shape tensor ops vmapped over rays; layers below the
tangent point get ds = 0 via the max() — no data-dependent shapes anywhere
(XLA requirement).  Curtis-Godson path averages (C12) are computed by
sub-sampling each layer crossing at ``n_sub`` equal-path-length points and
taking density-weighted sums — a fixed small quadrature instead of the
reference's per-ray adaptive loops.

Output contract (:class:`PathCG`): per (ray, layer, species) one-side column
u [molec m^-2] and CG averages (T_bar, p_bar, p_self_bar), plus the static
segment->layer map that orders layer crossings observer-first for the RT
integrator (C13).  For limb rays the atmosphere is spherically symmetric, so
the near/far crossings of a layer share CG state and column.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.data.atmosphere import Atmosphere, Planet


class PathCG(NamedTuple):
    """Curtis-Godson description of a batch of rays through a layered
    atmosphere.  R = n_rays, NL = n_layers (= n_lev - 1), S = n_species."""

    u: jnp.ndarray            # [R, NL, S] one-side species column [molec m^-2]
    T_sp: jnp.ndarray         # [R, NL, S] CG temperature per species [K]
    p_sp: jnp.ndarray         # [R, NL, S] CG pressure per species [Pa]
    p_self_sp: jnp.ndarray    # [R, NL, S] CG species partial pressure [Pa]
    T_air: jnp.ndarray        # [R, NL] air-density-weighted CG temperature
    seg_layer: jnp.ndarray    # [n_seg] int32, observer-first layer index
    seg_count: int            # static: number of segments
    is_limb: bool             # static: limb (2 crossings/layer) vs nadir (1)
    # Continuum/CIA support (C-CIA, round-1 review item 7):
    u_air: jnp.ndarray = None   # [R, NL] one-side AIR column [molec m^-2]
    uu_air: jnp.ndarray = None  # [R, NL] int n_air^2 ds, SCALED by UU_SCALE
                                #   (exact power of two; n^2 ~ 1e50 /m^5
                                #   overflows float32 unscaled)


# Exact power-of-two scale carried by PathCG.uu_air: (2^-83)^2 applied at the
# sample level keeps (n * 2^-83)^2 ~ O(1) in float32; CIA tables fold the
# inverse scale into their staged coefficients (ops/cia.py).
UU_SCALE = 2.0 ** -166


def _layer_samples_limb(z_lev, r_t, radius, n_sub):
    """Sub-sample points and weights for one limb ray.

    Returns (z_pts [NL, n_sub], w [NL, n_sub]) — altitudes and path-length
    weights [m] of the quadrature points of each one-side layer crossing.
    """
    r_lev = radius + z_lev
    l_lev = jnp.sqrt(jnp.maximum(r_lev ** 2 - r_t ** 2, 0.0))
    l_bot = l_lev[:-1]
    dl = l_lev[1:] - l_bot                                   # [NL]
    k = (jnp.arange(n_sub) + 0.5) / n_sub                    # [n_sub]
    l_k = l_bot[:, None] + dl[:, None] * k[None, :]          # [NL, n_sub]
    z_k = jnp.sqrt(r_t ** 2 + l_k ** 2) - radius
    w = jnp.broadcast_to((dl / n_sub)[:, None], l_k.shape)
    return z_k, w


def _layer_samples_nadir(z_lev, sec_theta, n_sub):
    """Sub-sample points/weights for a nadir ray with zenith-angle secant."""
    z_bot = z_lev[:-1]
    dz = z_lev[1:] - z_bot
    k = (jnp.arange(n_sub) + 0.5) / n_sub
    z_k = z_bot[:, None] + dz[:, None] * k[None, :]
    w = jnp.broadcast_to((dz * sec_theta / n_sub)[:, None], z_k.shape)
    return z_k, w


def _cg_from_samples(atm: Atmosphere, species: Sequence[str], z_k, w):
    """Curtis-Godson sums over quadrature samples of every layer.

    z_k, w: [NL, n_sub].  Returns per-layer (u, T_sp, p_sp, p_self_sp, T_air)
    with species axis last.
    """
    T = atm.interp_T(z_k)                    # [NL, n_sub]
    p = atm.interp_logp(z_k)
    n = atm.interp_n(z_k)

    # float32-safe weighted averages.  Two autodiff hazards live here:
    # (1) the division JVP squares the divisor, and SI columns (~1e25 /m^2)
    #     square to inf in f32 — so the AVERAGING weights are pre-scaled by
    #     an exact power of two (2^-83 ~ 1.03e-25; ratios are unchanged
    #     bit-for-bit, squares stay in normal range);
    # (2) empty layers (below the tangent) have exactly-zero columns, and
    #     `x/max(u, tiny)` gives 0*0/0 = NaN tangents on the masked branch —
    #     so the pattern is where(ok, u, 1) -> divide -> where(ok, val, def).
    CG_SCALE = 2.0 ** -83
    w_s = w * CG_SCALE
    n_air_col = jnp.sum(n * w_s, axis=-1)
    air_ok = n_air_col > 0
    T_air = jnp.sum(T * n * w_s, axis=-1) / jnp.where(air_ok, n_air_col, 1.0)
    T_air = jnp.where(air_ok, T_air, 200.0)
    u_air = n_air_col * (1.0 / CG_SCALE)               # [NL] molec m^-2
    # CIA path integral: int n^2 ds, scaled (n*2^-83)^2 * w -> UU_SCALE units.
    n_s = n * CG_SCALE
    uu_air = jnp.sum(n_s * n_s * w, axis=-1)           # [NL], x UU_SCALE

    us, Ts, ps, pss, oks = [], [], [], [], []
    for name in species:
        vmr = atm.interp_vmr(name, z_k)      # [NL, n_sub]
        ns = n * vmr
        u_s = jnp.sum(ns * w_s, axis=-1)     # [NL], scaled
        ok = u_s > 0
        u_div = jnp.where(ok, u_s, 1.0)
        Ts.append(jnp.sum(T * ns * w_s, axis=-1) / u_div)
        ps.append(jnp.sum(p * ns * w_s, axis=-1) / u_div)
        pss.append(jnp.sum(p * vmr * ns * w_s, axis=-1) / u_div)
        us.append(u_s * (1.0 / CG_SCALE))    # physical column [molec m^-2]
        oks.append(ok)
    stack = lambda xs: jnp.stack(xs, axis=-1)      # [NL, S]
    u = stack(us)
    ok = stack(oks)
    T_sp = jnp.where(ok, stack(Ts), 200.0)
    p_sp = jnp.where(ok, stack(ps), 1.0)
    p_self_sp = jnp.where(ok, stack(pss), 0.0)
    return u, T_sp, p_sp, p_self_sp, T_air, u_air, uu_air


def limb_path_cg(
    atm: Atmosphere,
    species: Sequence[str],
    tangent_heights_m: jnp.ndarray,
    planet: Planet,
    n_sub: int = 4,
) -> PathCG:
    """CG description of limb rays at the given tangent heights.

    Segment order (observer-first): near-side crossings top layer -> layer 0,
    then far-side crossings layer 0 -> top layer; crossings of layers below
    the tangent height carry zero column automatically.
    """
    n_lay = atm.n_lev - 1
    radius = planet.radius_m

    def one_ray(h_t):
        z_k, w = _layer_samples_limb(atm.z, radius + h_t, radius, n_sub)
        return _cg_from_samples(atm, species, z_k, w)

    u, T_sp, p_sp, p_self_sp, T_air, u_air, uu_air = jax.vmap(one_ray)(
        tangent_heights_m)
    seg_layer = np.concatenate([np.arange(n_lay)[::-1], np.arange(n_lay)])
    return PathCG(
        u=u, T_sp=T_sp, p_sp=p_sp, p_self_sp=p_self_sp, T_air=T_air,
        seg_layer=jnp.asarray(seg_layer, dtype=jnp.int32),
        seg_count=2 * n_lay, is_limb=True, u_air=u_air, uu_air=uu_air,
    )


def nadir_path_cg(
    atm: Atmosphere,
    species: Sequence[str],
    sec_theta: jnp.ndarray,
    n_sub: int = 4,
) -> PathCG:
    """CG description of nadir (down-looking) rays; ``sec_theta`` is the
    secant of the viewing zenith angle per ray ([R], 1.0 = pure nadir).
    Segment order: top layer -> layer 0 (then the surface background)."""
    n_lay = atm.n_lev - 1

    def one_ray(sec):
        z_k, w = _layer_samples_nadir(atm.z, sec, n_sub)
        return _cg_from_samples(atm, species, z_k, w)

    u, T_sp, p_sp, p_self_sp, T_air, u_air, uu_air = jax.vmap(one_ray)(
        sec_theta)
    seg_layer = np.arange(n_lay)[::-1]
    return PathCG(
        u=u, T_sp=T_sp, p_sp=p_sp, p_self_sp=p_self_sp, T_air=T_air,
        seg_layer=jnp.asarray(seg_layer, dtype=jnp.int32),
        seg_count=n_lay, is_limb=False, u_air=u_air, uu_air=uu_air,
    )
