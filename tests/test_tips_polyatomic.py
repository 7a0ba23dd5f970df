"""External anchors for the POLYATOMIC partition-function shapes
(round-3 review item 2 — the round-3 Dunham oracle covered only diatomics).

Strategy, extending tests/test_tips.py::test_shape_anchored_to_dunham_oracle:
for each molecule the five acceptance configs actually retrieve (H2O, CO2
626/636, CH4, O3, NH3), build an INDEPENDENT quantum-sum oracle in this
file — textbook rigid-rotor sums typed from scratch plus OBSERVED
vibrational term values from the spectroscopic literature (HITRAN/Herzberg
band origins) — and assert the production model's anchored shape
Q(T)/Q(296) against it.  The observed term values carry the anharmonicity,
Fermi-resonance shifts (CO2 1285/1388 dyad), l-type degeneracies, and
inversion doubling (NH3 0.79 cm^-1 ground split) that the production
model's HARMONIC vibrational product omits, and the O3 oracle replaces the
model's CLASSICAL rotor with an explicit asymmetric-top diagonalisation —
so each oracle independently probes exactly the physics its molecule's
kind approximates.  Only the SHAPE is compared (both sides normalised at
296 K) because only the shape reaches line-strength scaling
(ops/strengths.py).

Measured deviations (recorded in docs/ACCURACY.md; assertions at ~2x):

    CO2 626  (linear, Fermi dyad)   <= 0.011 % on 100-500 K; 0.53 % at 700 K
    CO2 636  (linear)               <= 0.026 % on 100-400 K
    H2O 161  (asym + ortho/para)    <= 0.003 % on 100-500 K; 0.044 % at 1000 K
    CH4 211  (spherical)            <= 0.031 % on 100-500 K
    O3  666  (QUANTUM vs classical) <= 0.074 % on 150-400 K
    NH3 4111 (symtop + inversion)   <= 0.21 % on 150-400 K

Oracle validity limits (documented, not hidden): each vib level list is
truncated (CO2 626 at ~3700 cm^-1, others lower), capping the highest
honest comparison temperature per molecule.  ROUND 5: the CO2 626 oracle
gains a polyad-cell completion above the truncation (the truncated list
is ~5 % low at 1000 K; the completed oracle pins the production shape to
0.13 % there — see test_co2_626_shape_high_t_with_polyad_completion).  H2O's oracle shares the rigid-rotor approximation with the
model (centrifugal distortion is untested — it needs measured rotational
levels beyond what can be hand-typed reliably); its oracle is still
independent code + observed vib levels.
"""

import numpy as np
import pytest

from spectrobot_tpu.data import tips

C2 = 1.4387769


# ---------------------------------------------------------------------------
# Independent quantum-sum machinery (typed from textbook formulas; shares
# NOTHING with spectrobot_tpu.data.tips beyond physics)
# ---------------------------------------------------------------------------

def _boltz(E, g, T):
    T = np.atleast_1d(np.asarray(T, float))
    return (np.asarray(g, float)[None, :]
            * np.exp(-C2 * np.asarray(E, float)[None, :] / T[:, None])
            ).sum(axis=1)


def _q_rot_linear(B, sigma, T, j_max=300):
    J = np.arange(j_max + 1, dtype=float)
    return _boltz(B * J * (J + 1), 2 * J + 1, T) / sigma


def _q_rot_spherical(B, sigma, T, j_max=120):
    J = np.arange(j_max + 1, dtype=float)
    return _boltz(B * J * (J + 1), (2 * J + 1) ** 2, T) / sigma


def _q_rot_symtop(B, C, sigma, T, j_max=120):
    E, g = [], []
    for J in range(j_max + 1):
        for K in range(-J, J + 1):
            E.append(B * J * (J + 1) + (C - B) * K * K)
            g.append(2 * J + 1)
    return _boltz(E, g, T) / sigma


def _asym_levels(A, B, C, j_max):
    """Rigid asymmetric-top levels by direct diagonalisation in the
    symmetric-top |J K> basis (Townes & Schawlow ch. 4):

        <K|H|K>    = (B+C)/2 [J(J+1) - K^2] + A K^2
        <K|H|K+-2> = (B-C)/4 sqrt(f(J,K) f(J,K+-1)),
        f(J,K) = J(J+1) - K(K+1)

    Returns (E, J, Ka, Kc) with the standard prolate-ordered ladder
    assignment (ascending energy <-> Ka rising / Kc falling)."""
    out = []
    for J in range(j_max + 1):
        n = 2 * J + 1
        K = np.arange(-J, J + 1, dtype=float)
        JJ = J * (J + 1.0)
        H = np.zeros((n, n))
        np.fill_diagonal(H, 0.5 * (B + C) * (JJ - K * K) + A * K * K)
        for i in range(n - 2):
            k = K[i]
            off = 0.25 * (B - C) * np.sqrt(
                (JJ - k * (k + 1)) * (JJ - (k + 1) * (k + 2)))
            H[i, i + 2] = H[i + 2, i] = off
        for i, e in enumerate(np.sort(np.linalg.eigvalsh(H))):
            out.append((e, J, (i + 1) // 2, J - i // 2))
    return out


def _q_rot_asym(A, B, C, T, j_max, spin=None, sigma=1):
    lv = _asym_levels(A, B, C, j_max)
    E = np.array([l[0] for l in lv])
    g = np.array([2 * l[1] + 1 for l in lv], float)
    if spin == "h2o":                    # ortho (Ka+Kc odd) : para = 3 : 1
        g = g * np.array([3.0 if (l[2] + l[3]) % 2 else 1.0 for l in lv])
    return _boltz(E, g, T) / sigma


def _q_vib_obs(levels, T):
    E = np.array([l[0] for l in levels])
    g = np.array([l[1] for l in levels], float)
    return _boltz(E, g, T)


# ---------------------------------------------------------------------------
# Observed vibrational term values [cm^-1] (HITRAN level energies /
# Herzberg band origins; l > 0 and degenerate modes carry their real
# degeneracies).  Each list includes the ground state and is complete
# through the quoted truncation energy.
# ---------------------------------------------------------------------------

CO2_626_VIB = [  # complete through ~3700 cm^-1 (incl. Fermi dyads/triads)
    (0.0, 1), (667.380, 2), (1285.409, 1), (1335.132, 2), (1388.185, 1),
    (1932.470, 2), (2003.246, 2), (2076.856, 2), (2349.143, 1),
    (2548.366, 1), (2585.022, 2), (2671.143, 1), (2671.717, 2),
    (2760.725, 2), (2797.136, 1), (3004.012, 2), (3181.46, 2),
    (3339.35, 2), (3340.5, 2), (3442.2, 2), (3500.67, 1), (3612.84, 1),
    (3659.27, 2), (3714.78, 1)]

CO2_636_VIB = [  # complete through ~2300 cm^-1
    (0.0, 1), (648.478, 2), (1265.828, 1), (1297.264, 2), (1370.063, 1),
    (1896.5, 2), (1946.3, 2), (2037.1, 2), (2283.488, 1)]

H2O_161_VIB = [  # fundamentals + bend overtones/combinations to ~5350
    (0.0, 1), (1594.746, 1), (3151.630, 1), (3657.053, 1), (3755.929, 1),
    (4666.79, 1), (5234.98, 1), (5331.27, 1)]

CH4_211_VIB = [  # nu4/nu2 + dyad/pentad members to ~3100 cm^-1
    (0.0, 1), (1310.76, 3), (1533.33, 2), (2587.0, 1), (2614.3, 2),
    (2624.6, 3), (2830.3, 3), (2846.1, 3), (2916.48, 1), (3019.49, 3),
    (3063.7, 2)]

O3_666_VIB = [  # fundamentals + binary combinations to ~2200 cm^-1
    (0.0, 1), (700.93, 1), (1042.08, 1), (1103.14, 1), (1399.27, 1),
    (1726.52, 1), (1796.26, 1), (2057.89, 1), (2110.78, 1), (2201.15, 1)]

NH3_4111_VIB = [  # inversion-split stack to ~1900 cm^-1
    (0.0, 1), (0.793, 1), (932.43, 1), (968.12, 1), (1597.47, 1),
    (1626.28, 2), (1627.37, 2), (1882.18, 1)]


def _assert_shape(key, q_oracle, Ts, tol):
    """Anchored-shape comparison: model Q(T)/Q(296) vs oracle's."""
    Ts = np.asarray(Ts, float)
    qm = np.array([float(tips.q_of_T(*key, t)) for t in Ts])
    qm296 = float(tips.q_of_T(*key, 296.0))
    qo = q_oracle(Ts)
    qo296 = q_oracle(np.array([296.0]))[0]
    rel = np.abs((qm / qm296) / (qo / qo296) - 1.0)
    assert rel.max() < tol, (key, Ts[np.argmax(rel)], rel.max())
    return rel.max()


T_LOW = [100.0, 150.0, 200.0, 250.0, 300.0, 400.0, 500.0]
T_MID = [150.0, 200.0, 250.0, 300.0, 400.0]


def test_co2_626_shape_vs_observed_levels():
    """Linear rotor + Fermi-coupled observed vib stack (the model's
    harmonic 3-mode product omits the 1285/1388 dyad splitting)."""
    q = lambda T: (_q_rot_linear(0.39022, 2, T)
                   * _q_vib_obs(CO2_626_VIB, T))
    _assert_shape((2, 1), q, T_LOW, 5e-4)
    # Mid-T probe: the oracle is complete enough at 700 K (truncation
    # bias ~0.1%); 1000 K stays with the diatomic Dunham oracle.
    _assert_shape((2, 1), q, [700.0], 1.2e-2)


# ---------------------------------------------------------------------------
# High-T completion of the CO2 626 oracle (round-5 review item 10): the
# observed list truncates at ~3714 cm^-1, which the module docstring
# records as ~5 % low at 1000 K.  Here the ORACLE (not the production
# model) gains a POLYAD-CELL tail.  Fermi resonance defeats a smooth
# G(v1, v2, v3) fit (per-level residuals +-150 cm^-1), but the g-weighted
# CENTERS of the bending polyads P = 2 v1 + v2 are almost exactly
# harmonic — computed in-code from the observed list itself: P=1..4
# centers 667.4, 1336.0, 2004.2, 2672.4 (steps ~668.2).  The model:
#
#   E(P, v3) = wP P + xPP P^2 + w3 v3 + x33 v3^2 + xP3 P v3
#   g(P)     = sum over polyad members (v2 = P, P-2, ...) of (v2 + 1)
#
# with (wP, xPP) LSQ-fit to the in-code polyad centers, (w3, x33) from
# the observed 00011 (in the list) plus the ONE typed external constant
# E(00021) = 4673.325 cm^-1 [Herzberg/HITRAN], and xP3 from the observed
# (P=1, v3=1) level 3004.012.  The partition sum is then
#
#   Q_vib = sum_cells g(P) e^(-c2 E(P,v3)/T)
#         + sum_obs  g_i (e^(-c2 E_i/T) - e^(-c2 E_center(i)/T))
#
# — every cell at its center energy, with each OBSERVED level replacing
# its own cell-center term by the true energy (binned to the nearest
# center).  Polyad splitting is symmetric about the center, so the
# residual bias on unobserved members is second order (~0.1 % of Q at
# 1000 K); the tail itself is ~3-5 % of Q_vib there.
# ---------------------------------------------------------------------------


def _co2_626_cells(e_max=15000.0):
    """(centers dict {(P, v3): E}, wP, xPP) from the observed list."""
    # g-weighted polyad centers P = 1..4 from unambiguous energy windows.
    windows = {1: (600.0, 700.0), 2: (1250.0, 1450.0),
               3: (1900.0, 2100.0), 4: (2500.0, 2850.0)}
    centers_P = {}
    for P, (lo, hi) in windows.items():
        members = [(E, g) for E, g in CO2_626_VIB if lo <= E <= hi]
        gs = sum(g for _, g in members)
        centers_P[P] = sum(E * g for E, g in members) / gs
        # The window must contain the FULL polyad (degeneracy check).
        assert gs == sum(v2 + 1 for v2 in range(P, -1, -2)), (P, gs)
    A = np.array([[P, P * P] for P in centers_P])
    y = np.array([centers_P[P] for P in centers_P])
    (wP, xPP), *_ = np.linalg.lstsq(A, y, rcond=None)
    assert abs(np.asarray(A @ np.array([wP, xPP]) - y)).max() < 5.0
    # v3 ladder: 00011 observed (in the list), 00021 typed (Herzberg).
    e_00011 = 2349.143
    e_00021 = 4673.325
    x33 = (e_00021 - 2.0 * e_00011) / 2.0
    w3 = e_00011 - x33
    # P-v3 coupling from the observed (P=1, v3=1) level 3004.012.
    xP3 = 3004.012 - (wP + xPP) - e_00011
    cells = {}
    for v3 in range(0, 8):
        for P in range(0, 40):
            E = (wP * P + xPP * P * P + w3 * v3 + x33 * v3 * v3
                 + xP3 * P * v3)
            if E > e_max and P > 0:
                break
            if E <= e_max:
                cells[(P, v3)] = E
    return cells, float(wP), float(xPP)


def _bin_observed_to_cells(cells):
    """Capacity-aware greedy binning of the observed levels to the
    polyad cells: tightest matches first, each observed member consuming
    cell capacity g(P), spilling to the next-nearest cell with room
    (polyad spreads overlap near the truncation edge — e.g. the 3500.67
    level sits between the (P=2, v3=1) and (P=5, v3=0) centers).
    Returns (center_energy per observed level, max assignment distance)."""
    keys = list(cells)
    E_c = np.array([cells[k] for k in keys])
    cap = {k: sum(v2 + 1 for v2 in range(k[0], -1, -2)) for k in keys}
    obs = sorted(range(len(CO2_626_VIB)),
                 key=lambda i: np.abs(CO2_626_VIB[i][0] - E_c).min())
    near = np.zeros(len(CO2_626_VIB))
    dist_max = 0.0
    for i in obs:
        E, g = CO2_626_VIB[i]
        for j in np.argsort(np.abs(E - E_c)):
            k = keys[int(j)]
            if cap[k] >= g:
                cap[k] -= g
                near[i] = E_c[int(j)]
                dist_max = max(dist_max, abs(E - E_c[int(j)]))
                break
        else:
            raise AssertionError(f"no cell capacity for level {E}")
    return near, dist_max


def _co2_626_vib_completed(T):
    cells, _, _ = _co2_626_cells()
    keys = list(cells)
    E_c = np.array([cells[k] for k in keys])
    g_c = np.array([sum(v2 + 1 for v2 in range(k[0], -1, -2))
                    for k in keys], float)
    q_cells = _boltz(E_c, g_c, T)
    # Observed correction: each observed level replaces its own
    # cell-center term (capacity-aware binning) by the true energy.
    E_obs = np.array([E for E, _ in CO2_626_VIB])
    g_obs = np.array([g for _, g in CO2_626_VIB], float)
    near, _ = _bin_observed_to_cells(cells)
    corr = (_boltz(E_obs, g_obs, T) - _boltz(near, g_obs, T))
    return q_cells + corr


def test_co2_626_polyad_cells_are_consistent():
    """The in-code polyad model reproduces the observed list itself:
    every observed level fits a cell within the polyad half-spread, with
    cell capacities respected (the binning raises otherwise)."""
    cells, wP, xPP = _co2_626_cells()
    assert abs(wP - 668.0) < 3.0 and abs(xPP) < 2.0, (wP, xPP)
    _, dist_max = _bin_observed_to_cells(cells)
    assert dist_max < 210.0, dist_max


def test_co2_626_shape_high_t_with_polyad_completion():
    """1000 K anchor for the production CO2 626 shape against the
    polyad-completed oracle (replaces the 'remains the diatomic oracle's'
    caveat); the low-T shape must be unchanged by the tail."""
    q = lambda T: (_q_rot_linear(0.39022, 2, T)
                   * _co2_626_vib_completed(T))
    _assert_shape((2, 1), q, T_LOW, 5e-4)      # tail invisible below 500 K
    # Measured deviations: -0.05 % at 700 K, -0.09 % at 850 K, -0.13 % at
    # 1000 K (the tail itself is +5.0 % of Q_vib at 1000 K — exactly the
    # truncation bias the module docstring predicted); asserted at ~3x.
    _assert_shape((2, 1), q, [700.0], 2e-3)
    _assert_shape((2, 1), q, [850.0, 1000.0], 4e-3)


def test_co2_636_shape_vs_observed_levels():
    q = lambda T: (_q_rot_linear(0.39024, 2, T)
                   * _q_vib_obs(CO2_636_VIB, T))
    _assert_shape((2, 2), q, [100.0, 150.0, 200.0, 250.0, 300.0, 400.0],
                  1e-3)


def test_h2o_161_shape_vs_independent_diagonalisation():
    """Independent asym-top diagonalisation (ortho/para 3:1) + observed
    vib levels; also cross-validates the ladder (Ka, Kc) assignment the
    spin weights depend on."""
    q = lambda T: (_q_rot_asym(27.8806, 14.5216, 9.2778, T, j_max=45,
                               spin="h2o")
                   * _q_vib_obs(H2O_161_VIB, T))
    _assert_shape((1, 1), q, T_LOW, 1e-4)
    _assert_shape((1, 1), q, [700.0, 1000.0], 1e-3)


def test_ch4_211_shape_vs_observed_levels():
    """Spherical top ((2J+1)^2) + observed dyad/pentad vib levels (the
    model's harmonic product has no 2nu4/nu2+nu4 splitting)."""
    q = lambda T: (_q_rot_spherical(5.2410, 12, T)
                   * _q_vib_obs(CH4_211_VIB, T))
    _assert_shape((6, 1), q, T_LOW, 1e-3)


def test_o3_666_quantum_rotor_vs_classical_model():
    """O3's production kind is the CLASSICAL rotor; this oracle is the
    explicit quantum asymmetric-top sum (j_max=90 converges the 296 K and
    400 K sums to <1e-5) + observed vib levels — the one polyatomic where
    the oracle upgrades the ROTATIONAL physics, not just the vibrational.
    Measured: classical-rotor shape error peaks at -0.067% at 150 K."""
    q = lambda T: (_q_rot_asym(3.5537, 0.44526, 0.39479, T, j_max=90)
                   * _q_vib_obs(O3_666_VIB, T))
    _assert_shape((3, 1), q, T_MID, 2e-3)


def test_nh3_4111_shape_vs_inversion_split_levels():
    """Symmetric top + the observed INVERSION-split vib stack (0/0.793,
    932/968 doublets) the harmonic model collapses to single levels."""
    q = lambda T: (_q_rot_symtop(9.9466, 6.2280, 3, T)
                   * _q_vib_obs(NH3_4111_VIB, T))
    _assert_shape((11, 1), q, T_MID, 4e-3)


def test_oracle_self_consistency_asym_ladder():
    """The independent diagonaliser must reproduce H2O's textbook low-J
    levels (101 = 23.79, 111 = 37.14, 110 = 42.37 cm^-1) — guards the
    oracle itself against a transcription slip."""
    lv = {(l[1], l[2], l[3]): l[0]
          for l in _asym_levels(27.8806, 14.5216, 9.2778, 3)}
    assert abs(lv[(1, 0, 1)] - 23.79) < 0.05
    assert abs(lv[(1, 1, 1)] - 37.14) < 0.05
    assert abs(lv[(1, 1, 0)] - 42.37) < 0.05
    assert abs(lv[(2, 1, 2)] - 79.50) < 0.3
