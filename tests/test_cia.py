"""Collision-induced absorption / continuum hook (round-1 review item 7)."""

import numpy as np

import jax
import jax.numpy as jnp

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import (
    UU_SCALE, limb_path_cg, nadir_path_cg)
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.cia import (
    cia_dtau, cia_from_arrays, demo_co2_cia, parse_cia_text, stage_cia)
from spectrobot_tpu.ops.planck import planck_nu
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


def _scene(n_lev=9):
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=60e3)
    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 160))
    return atm, dl, nu


def test_uu_air_uniform_slab_analytic():
    """For a nadir path, int n^2 ds must match the trapezoid of the actual
    density profile (same quadrature as the column) — checked by comparing
    uu against the quadrature of n^2 computed independently."""
    atm, _, _ = _scene(n_lev=17)
    cg = nadir_path_cg(atm, ["CO2"], jnp.asarray([1.0]), n_sub=64)
    uu = np.asarray(cg.uu_air[0]) / UU_SCALE          # [NL] physical m^-5
    # Independent estimate: sample n(z) on the same midpoint rule.
    z = np.asarray(atm.z)
    ref = []
    for i in range(len(z) - 1):
        zz = z[i] + (np.arange(64) + 0.5) / 64 * (z[i + 1] - z[i])
        n = np.asarray(atm.interp_n(jnp.asarray(zz)))
        ref.append(np.sum(n ** 2) * (z[i + 1] - z[i]) / 64)
    np.testing.assert_allclose(uu, np.asarray(ref), rtol=1e-6)


def test_cia_dtau_positive_and_t_interpolated():
    atm, _, nu = _scene()
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray([10e3, 30e3]), MARS, 4)
    tab = demo_co2_cia(nu_min=600.0, nu_max=700.0)
    cia = stage_cia(nu, [tab], ["CO2"], dtype=jnp.float64)
    dtau = np.asarray(cia_dtau(cia, cg))
    assert dtau.shape == (2, atm.n_lev - 1, nu.shape[0])
    assert np.isfinite(dtau).all() and (dtau >= 0).all()
    # Low tangent ray accumulates more continuum than the high one.
    assert dtau[0].sum() > dtau[1].sum()


def test_forward_with_cia_differs_and_is_thermalised():
    """Radiance with the continuum differs from without; in LTE the added
    opacity pulls the limb spectrum toward B(T) (never past it)."""
    atm, dl, _ = _scene()
    # Window OFF the band (the 15 um band saturates the limb path — an
    # opaque path hides any added opacity), strong synthetic continuum.
    nu = jnp.asarray(np.linspace(690.0, 700.0, 160))
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray([8e3]), MARS, 4)
    tab = cia_from_arrays(
        "CO2", "CO2", np.linspace(600.0, 720.0, 64),
        np.array([100.0, 300.0]),
        np.full((2, 64), 2e-44))
    cia = stage_cia(nu, [tab], ["CO2"], dtype=jnp.float64)
    I0 = np.asarray(limb_radiance(nu, dl, cg))[0]
    I1 = np.asarray(limb_radiance(nu, dl, cg, cia=cia))[0]
    assert np.max(np.abs(I1 - I0)) > 10 * np.max(I0) * 1e-6
    # Thermalised: the continuum can only pull the spectrum toward (never
    # past) the warmest Planck curve on the path.
    B_max = float(np.max(np.asarray(planck_nu(nu, float(np.max(atm.T))))))
    assert (I1 <= B_max * (1 + 1e-9)).all()


def test_cia_jacobian_flows():
    """Retrieval Jacobians see the continuum: dI/dT through cia_dtau's
    T interpolation AND the VMR state through the mixing-ratio weights."""
    from spectrobot_tpu.retrieval.state import (
        build_forward, flatten_state, make_state)

    atm, dl, nu = _scene(n_lev=5)
    tab = cia_from_arrays(
        "CO2", "CO2", np.linspace(600.0, 720.0, 64),
        np.array([100.0, 300.0]),
        np.stack([np.full(64, 3e-45), np.full(64, 1e-45)]))
    cia = stage_cia(nu, [tab], ["CO2"], dtype=jnp.float64)
    ths = jnp.asarray([8e3, 25e3])
    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=ths,
                        cia=cia)
    x0, unravel = flatten_state(make_state(atm, retrieve_vmr=["CO2"]))
    J = jax.jacfwd(lambda x: fwd(unravel(x)))(x0)
    assert bool(jnp.isfinite(J).all())
    # and the continuum actually changes the Jacobian
    fwd0 = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=ths)
    J0 = jax.jacfwd(lambda x: fwd0(unravel(x)))(x0)
    assert float(jnp.max(jnp.abs(J - J0))) > 0.0


def test_parse_cia_text_round_trip():
    tab = demo_co2_cia(nu_min=600.0, nu_max=700.0)
    blocks = []
    for j, T in enumerate(tab.T_grid):
        n = tab.nu_grid.shape[0]
        blocks.append(f"CO2-CO2 {tab.nu_grid[0]:.4f} {tab.nu_grid[-1]:.4f} "
                      f"{n} {T:.1f} {tab.k[j].max():.3e}")
        blocks.extend(f"{x:.6f} {k:.6e}" for x, k in zip(tab.nu_grid, tab.k[j]))
    parsed = parse_cia_text("\n".join(blocks), "CO2", "CO2")
    np.testing.assert_allclose(parsed.T_grid, tab.T_grid)
    np.testing.assert_allclose(parsed.k, tab.k, rtol=2e-6)


def test_stage_skips_absent_pairs():
    nu = jnp.asarray(np.linspace(600.0, 700.0, 32))
    tab = demo_co2_cia()
    assert stage_cia(nu, [tab], ["H2O"]) is None
    staged = stage_cia(nu, [tab], ["H2O", "CO2"])
    assert staged is not None and staged.pair_a == (1,) and staged.pair_b == (1,)


def test_cli_cia_config(tmp_path):
    from spectrobot_tpu.config import load_config

    p = tmp_path / "c.toml"
    p.write_text("[cia]\nenabled = true\ntables = [\"demo:co2\"]\n")
    cfg = load_config(str(p))
    assert cfg.cia.enabled and tuple(cfg.cia.tables) == ("demo:co2",)
    cfg2 = load_config(str(p), overrides={"cia.enabled": "false"})
    assert not cfg2.cia.enabled


def test_cia_sharded_matches_single_device():
    """CIA x mesh (round-2 review item 6): the continuum is additive
    per (ray, layer, nu) with no line data, so its tables shard over 'nu'
    and the sharded forward must match the single-device continuum forward
    to f64 roundoff on the 8-device emulated mesh."""
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 emulated devices")
    from spectrobot_tpu.forward.geometry import limb_path_cg as _lpc
    from spectrobot_tpu.parallel.mesh import make_mesh
    from spectrobot_tpu.parallel.sharded import (
        pad_lines_for_mesh, sharded_radiance_fn, stage_sharded)

    atm, dl, _ = _scene()
    nu = jnp.asarray(np.linspace(660.0, 674.0, 256))
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray([8e3, 16e3, 24e3, 32e3]),
                      MARS, 4)
    tab = demo_co2_cia(nu_min=600.0, nu_max=700.0)
    cia = stage_cia(nu, [tab], ["CO2"], dtype=jnp.float64)
    ref = np.asarray(jax.jit(lambda: limb_radiance(nu, dl, cg, cia=cia))())

    mesh = make_mesh((2, 2, 2))
    dlp = pad_lines_for_mesh(dl, 2)
    f = sharded_radiance_fn(mesh, has_nlte=False, has_background=False,
                            cia_pairs=(cia.pair_a, cia.pair_b))
    nu_s, lines_s, cg_s, _, _, cia_s = stage_sharded(mesh, nu, dlp, cg,
                                                     cia=cia)
    got = np.asarray(f(nu_s, lines_s, cg_s, cia=cia_s))
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)


# ---------------------------------------------------------------------------
# Genuine-format .cia block parsing (round-3 review item 5)
# ---------------------------------------------------------------------------
# Hand-typed in the authentic HITRAN .cia layout (header line: pair label,
# nu_min, nu_max, n_points, temperature, max_cia, then n_points "nu k"
# rows; one block per temperature) — not produced by this repo.  The
# second block's grid is deliberately offset to exercise the
# re-interpolation onto the first block's grid.

GENUINE_CIA = """\
              N2-N2   10.000    50.000     5  200.0 5.000E-46
   10.000  1.000E-46
   20.000  3.000E-46
   30.000  5.000E-46
   40.000  3.500E-46
   50.000  1.500E-46
              N2-N2   12.000    52.000     5  300.0 4.000E-46
   12.000  0.800E-46
   22.000  2.400E-46
   32.000  4.000E-46
   42.000  2.800E-46
   52.000  1.200E-46
"""


def test_genuine_cia_blocks_parse():
    from spectrobot_tpu.ops.cia import parse_cia_text

    t = parse_cia_text(GENUINE_CIA, "N2", "N2")
    assert t.species_a == "N2" and t.species_b == "N2"
    np.testing.assert_allclose(t.T_grid, [200.0, 300.0])
    np.testing.assert_allclose(t.nu_grid, [10.0, 20.0, 30.0, 40.0, 50.0])
    # First block verbatim on its own grid.
    np.testing.assert_allclose(
        t.k[0], [1.0e-46, 3.0e-46, 5.0e-46, 3.5e-46, 1.5e-46])
    # Second block re-interpolated onto the first grid: left edge (10 <
    # 12) clamps to 0, interior is linear between the offset samples.
    assert t.k[1][0] == 0.0
    np.testing.assert_allclose(
        t.k[1][1], np.interp(20.0, [12.0, 22.0], [0.8e-46, 2.4e-46]))
    assert np.all(t.k >= 0)


def test_cia_malformed_header_rejected():
    import pytest
    from spectrobot_tpu.ops.cia import parse_cia_text

    bad = GENUINE_CIA.replace("     5  200.0", "  five  200.0", 1)
    with pytest.raises(ValueError):
        parse_cia_text(bad, "N2", "N2")
