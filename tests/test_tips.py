"""Partition sums (component C2).

Round 2 (the review item 2): every registered isotopologue is ANCHORED to
its HITRAN molparam Q(296 K) — exact by construction — and the temperature
dependence comes from explicit quantum state sums (exact linear-rotor J
sums, asymmetric-top diagonalisation for H2O, spherical-top sums for CH4).
Only RATIOS Q(296)/Q(T) enter line-strength scaling, so the anchor also
normalises away constant nuclear-spin degeneracy factors.
"""

import warnings

import numpy as np
import pytest

from spectrobot_tpu.data import tips


def test_q296_anchors_exact():
    """Q(296) equals the embedded HITRAN molparam value for EVERY iso."""
    for key, q296 in tips.Q296.items():
        got = float(tips.q_of_T(*key, 296.0))
        assert abs(got - q296) / q296 < 1e-10, (key, got, q296)


def test_linear_rotor_sum_matches_euler_maclaurin_high_T():
    """The exact J sum agrees with the analytic high-T expansion where the
    latter is valid (small c2 B / T) — cross-checks the sum machinery."""
    B, sigma, T = 0.39022, 2, np.array([296.0, 600.0, 1200.0])
    exact = tips._q_rot_linear(B, sigma, T)
    beta = tips.C2 * B / T
    approx = (1.0 / sigma) / beta * (1.0 + beta / 3.0 + beta ** 2 / 15.0)
    np.testing.assert_allclose(exact, approx, rtol=1e-6)


def test_asym_top_levels_match_known_h2o():
    """Lowest rigid-rotor H2O levels vs textbook J_{Ka,Kc} energies
    (rigid-rotor values from A, B, C; e.g. 1_01 = B + C)."""
    A, B, C = 27.8806, 14.5216, 9.2778
    E, g, par = tips._asym_top_levels(A, B, C, j_max=2)
    E0 = np.sort(E)[:4]
    # 0_00 = 0; 1_01 = B+C; 1_11 = A+C; 1_10 = A+B
    np.testing.assert_allclose(
        E0, [0.0, B + C, A + C, A + B], atol=1e-9)
    # ortho/para parity: ground state 0_00 is para (Ka+Kc even)
    assert par[0] == 0


def test_h2o_low_T_beats_classical():
    """At 50 K the direct sum must deviate from the classical rotor by
    several percent (that deviation is the point of diagonalising)."""
    spec = tips._SPECIES[(1, 1)]
    # The ortho/para-weighted sum is normalised so its high-T limit equals
    # the 1/sigma classical rotor (spin factors cancel into the anchor).
    T = np.array([50.0])
    q_exact = tips._q_rot_asym(spec["ABC"], spec["sigma"], "h2o", T)[0]
    q_class = tips._q_rot_classical(spec["ABC"], spec["sigma"], T)[0]
    assert abs(q_exact / q_class - 1.0) > 0.03
    # ... and converge to it at high T (equipartition).
    T = np.array([800.0])
    q_exact = tips._q_rot_asym(spec["ABC"], spec["sigma"], "h2o", T)[0]
    q_class = tips._q_rot_classical(spec["ABC"], spec["sigma"], T)[0]
    np.testing.assert_allclose(q_exact, q_class, rtol=0.02)


def test_q_monotone_increasing():
    for key in [(2, 1), (5, 1), (1, 1), (6, 1), (3, 1), (27, 1)]:
        q = tips.q_table(*key)
        assert np.all(np.diff(q) > 0)


def test_ratio_sane():
    # Q(296)/Q(T) < 1 for T > 296 and > 1 for T < 296.
    for key in [(2, 1), (1, 1)]:
        q296 = tips.q_of_T(*key, 296.0)
        assert q296 / tips.q_of_T(*key, 500.0) < 1.0
        assert q296 / tips.q_of_T(*key, 150.0) > 1.0


def test_co2_ratio_near_linear_in_T_low_range():
    """CO2 below 300 K: Q is rotation-dominated, so Q(T) ~ a*T with a small
    vibrational correction — the anchored ratio at 200 K must sit within a
    percent of the published TIPS ratio (~0.632)."""
    r = float(tips.q_of_T(2, 1, 200.0) / tips.q_of_T(2, 1, 296.0))
    assert abs(r - 0.632) < 0.01, r


def test_register_override():
    temps = np.linspace(50, 1000, 20)
    vals = 2.0 * np.interp(temps, tips.T_GRID, tips.q_table(5, 1))
    tips.register_q_table(5, 3, temps, vals)
    try:
        q = tips.q_of_T(5, 3, 296.0)
        np.testing.assert_allclose(q, 2.0 * tips.q_of_T(5, 1, 296.0), rtol=5e-3)
    finally:
        tips._REGISTERED.pop((5, 3), None)
        tips._CACHE.pop((5, 3), None)


def test_pack_tables_shape():
    t = tips.pack_q_tables([(2, 1), (5, 1), (1, 1)])
    assert t.shape == (3, tips.T_GRID.shape[0])
    assert np.all(t > 0)


def test_out_of_grid_warns():
    with pytest.warns(UserWarning, match="outside the table grid"):
        tips.q_of_T(2, 1, 10.0)
    with pytest.warns(UserWarning, match="outside the table grid"):
        tips.q_of_T(2, 1, 2000.0)


def test_unknown_iso_fallback_warns():
    with pytest.warns(UserWarning, match="main isotopologue"):
        tips.q_table(5, 98)
    with pytest.raises(KeyError):
        tips.q_table(99, 1)


def test_registry_covers_all_55_molecules():
    """round-2 review item 2 'done' criterion: q_table(m, 1) succeeds
    for every HITRAN molecule 1-55, produces a positive, finite, strictly
    increasing Q(T), and hits the molparam anchor exactly where one is
    embedded."""
    for m in range(1, 56):
        tab = tips.q_table(m, 1)
        assert np.isfinite(tab).all() and tab.min() > 0, m
        assert np.all(np.diff(tab) > 0), f"Q(T) not monotonic for mol {m}"
        if (m, 1) in tips.Q296:
            np.testing.assert_allclose(
                np.interp(296.0, tips.T_GRID, tab), tips.Q296[(m, 1)],
                rtol=1e-6, err_msg=f"mol {m} anchor")


def _q_dunham(we, wexe, Be, ae, De, T):
    """Independent diatomic oracle: explicit rovibrational level sum from
    the Dunham expansion E(v, J) = we(v+1/2) - wexe(v+1/2)^2
    + [Be - ae(v+1/2)] J(J+1) - De J^2(J+1)^2, referenced to E(0, 0).

    This carries the two physical effects the production model OMITS
    (anharmonicity, vibration-rotation interaction), with constants typed
    from the NIST/Huber-Herzberg diatomic tables — an EXTERNAL check of the
    anchored shape Q(T)/Q(296), which is the only thing line-strength
    scaling consumes (round-2 review item 3).  v/J ranges capped below
    the (unphysical) polynomial turnovers.
    """
    v_max = min(int(we / (2 * wexe) - 0.5), 20)
    v = np.arange(v_max + 1, dtype=float)
    Ev = we * (v + 0.5) - wexe * (v + 0.5) ** 2
    Ev -= Ev[0]
    Bv = Be - ae * (v + 0.5)
    j_max = int(np.sqrt(max(Bv.min(), 0.1) / (2 * De)))
    J = np.arange(min(j_max, 400) + 1, dtype=float)
    JJ = J * (J + 1.0)
    E = Ev[:, None] + Bv[:, None] * JJ[None, :] - De * JJ[None, :] ** 2
    g = 2.0 * J + 1.0
    return np.asarray([float((g[None, :] * np.exp(-1.4387769 * E / t)).sum())
                       for t in np.atleast_1d(T)])


# NIST / Huber-Herzberg X-state constants [cm-1].
_DUNHAM = {
    (5, 1): dict(we=2169.8136, wexe=13.2883, Be=1.93128, ae=0.01750,
                 De=6.1216e-6),                                    # 12C16O
    (15, 1): dict(we=2990.946, wexe=52.8186, Be=10.59341, ae=0.30718,
                  De=5.3194e-4),                                   # H35Cl
    (14, 1): dict(we=4138.32, wexe=89.88, Be=20.9557, ae=0.798,
                  De=2.151e-3),                                    # H19F
}


@pytest.mark.parametrize("key,tol_400,tol_1000", [
    ((5, 1), 1e-3, 3e-3),    # CO: docstring's <0.1% class below 400 K
    ((15, 1), 2e-3, 7e-3),   # hydrides: larger anharmonicity
    ((14, 1), 2e-3, 7e-3),
])
def test_shape_anchored_to_dunham_oracle(key, tol_400, tol_1000):
    """The anchored SHAPE Q(T)/Q(296) must track the anharmonic oracle:
    turns the tips.py docstring accuracy claim into a passing assertion
    (measured: CO +0.05%/-0.22%, HCl/HF +-0.15%/-0.55% at 100/1000 K —
    recorded in docs/ACCURACY.md)."""
    c = _DUNHAM[key]
    T_lo = np.array([100.0, 150.0, 200.0, 250.0, 350.0, 400.0])
    T_hi = np.array([500.0, 700.0, 1000.0])
    qd296 = _q_dunham(**c, T=296.0)[0]
    qm296 = tips.q_of_T(*key, 296.0)
    for Ts, tol in ((T_lo, tol_400), (T_hi, tol_1000)):
        shape_model = tips.q_of_T(*key, Ts) / qm296
        shape_oracle = _q_dunham(**c, T=Ts) / qd296
        rel = np.abs(shape_model / shape_oracle - 1.0)
        assert rel.max() < tol, (key, Ts[np.argmax(rel)], rel.max())


def test_h2_ortho_para_shape():
    """H2's explicit para/ortho J-parity weights: the model must reproduce
    the exact low-T sum (J = 0..3 dominate below 300 K) computed inline —
    Q(296) ~ 7.67 with the 3:1 alternation, NOT the sigma = 2 classical
    limit (which is ~40% wrong at 100 K)."""
    B = 59.3344
    J = np.arange(0, 12, dtype=float)
    g = (2 * J + 1) * np.where(J % 2 == 1, 3.0, 1.0)
    q = lambda T: float((g * np.exp(-1.4387769 * B * J * (J + 1) / T)).sum())
    # Shape comparison (the recalled molparam anchor rescales the absolute
    # level by ~0.5%; only Q(T)/Q(296) reaches line-strength scaling).
    for T in (100.0, 200.0, 250.0):
        np.testing.assert_allclose(
            tips.q_of_T(45, 1, T) / tips.q_of_T(45, 1, 296.0),
            q(T) / q(296.0), rtol=2e-3, err_msg=str(T))
    # And the absolute anchor is within 1% of the exact sum.
    np.testing.assert_allclose(tips.q_of_T(45, 1, 296.0), q(296.0), rtol=1e-2)


def test_multi_species_forward_nh3_so2():
    """A species pair with NO round-2 partition data (NH3 mol 11, SO2 mol
    9) runs end-to-end through the forward model — the round-2 review
    item 2 'opacity is computable' criterion, not just registry parsing."""
    import jax.numpy as jnp

    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import rovib_band
    from spectrobot_tpu.forward.geometry import limb_path_cg
    from spectrobot_tpu.forward.limb import limb_radiance
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    nh3 = rovib_band(mol_id=11, iso_id=1, nu_band=950.0, s_band=2.0e-19,
                     b_rot=8.0, j_max=10)
    so2 = rovib_band(mol_id=9, iso_id=1, nu_band=1151.7, s_band=3.0e-20,
                     b_rot=0.3, j_max=10)
    so2.nu0[:] = so2.nu0 - 1151.7 + 955.0      # co-locate for a small grid
    ll = nh3.concat(so2)
    dl = device_lines_from_linelist(ll, [(11, 1), (9, 1)], dtype=jnp.float64)
    atm = mars_standard_atmosphere(n_lev=7, z_top=60e3)
    atm = atm.with_vmr("NH3", 1e-6 * jnp.ones(7))
    atm = atm.with_vmr("SO2", 5e-7 * jnp.ones(7))
    nu = jnp.asarray(np.linspace(935.0, 975.0, 128))
    cg = limb_path_cg(atm, ["NH3", "SO2"], jnp.asarray([10e3, 25e3]), MARS, 2)
    I = np.asarray(limb_radiance(nu, dl, cg, chunk=64))
    assert np.isfinite(I).all() and (I >= 0).all() and I.max() > 0
