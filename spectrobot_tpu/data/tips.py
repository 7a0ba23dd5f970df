"""Total internal partition sums Q(T) (component C2, SURVEY.md section 3).

The reference (fedef17/SpectRobot ``spect_classes.py`` [SURVEY.md 1.2]) scales
line strengths with TIPS partition sums.  Design: every
(molecule, isotopologue) gets a dense Q(T) table on a shared temperature grid,
packed into one ``(n_species, n_T)`` array; runtime evaluation is a single
linear interpolation per species — branch-free, jit-friendly, trivially
sharded.

Data source (this image has no network access, so official TIPS-2021 files
cannot be shipped verbatim; round-1 review item 2):

* **Anchor**: the HITRAN ``molparam`` reference partition sums Q(296 K) —
  published scalar constants — are embedded per isotopologue and hold exactly:
  ``q_of_T(m, i, 296.0) == Q296``.
* **Temperature dependence**: explicit quantum state sums from published
  spectroscopic constants — exact rigid-rotor J-sums for linear molecules,
  asymmetric-top diagonalisation with ortho/para nuclear-spin weights for
  H2O, direct spherical-top sums for CH4, classical rotor for heavy
  asymmetric tops (where c2*A << kT over the whole grid), times the harmonic
  vibrational product over all modes.  The model curve is rescaled so it
  passes through the Q296 anchor, so only the *shape* Q(T)/Q(296) comes from
  the model — which is what line-strength scaling (ops/strengths.py) consumes.
  For linear rotors the anchored shape is exact in B to first order (the 1/B
  prefactor cancels), leaving harmonic-vs-anharmonic vibration as the leading
  residual: <0.1% below 400 K for CO2/CO/N2O-class molecules, growing to
  ~1% near 1000 K.
* **Override**: :func:`register_q_table` installs an external (e.g. official
  TIPS) table per isotopologue, which takes precedence.

Because the SAME packed tables feed the golden NumPy oracle and the device
path, all acceptance configs remain self-consistent under any table source.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np

from spectrobot_tpu.constants import C2

# Shared temperature grid for all packed tables [K].
T_GRID = np.linspace(20.0, 1500.0, 297)  # 5 K spacing
T_REF = 296.0

__all__ = ["T_GRID", "T_REF", "q_table", "q_of_T", "pack_q_tables",
           "register_q_table", "Q296"]


# ---------------------------------------------------------------------------
# Spectroscopic constants (published; HITRAN/NIST diatomic + polyatomic
# tables).  Layout:
#   linear:    kind="linear",    B [cm-1], sigma, modes=((omega_i, d_i), ...)
#              spin="h2" applies H2-type para/ortho (1:3) weights by J parity
#   symtop:    kind="symtop",    B, X (= A prolate / C oblate) [cm-1], sigma,
#              modes — direct (J, K) sum of E = B J(J+1) + (X - B) K^2
#   asym:      kind="asym",      ABC [cm-1], sigma, modes; spin="h2o" applies
#              para/ortho (1:3) weights by Ka+Kc parity
#   spherical: kind="spherical", B, sigma, modes
#   classical: kind="classical", ABC (or effective), sigma, modes — heavy
#              tops where the classical rotor is exact to <1e-4 on the grid
#   atom:      kind="atom"       — no rotation/vibration; Q is Q_elec alone
# Optional per-species keys:
#   elec = ((E_i [cm-1], g_i), ...) low-lying electronic / spin-orbit /
#          fine-structure levels; Q_elec(T) = sum g_i exp(-c2 E_i / T)
#          multiplies the rovibrational product.  CONSTANT electronic or
#          nuclear-spin degeneracies are omitted — they cancel through the
#          Q296 anchor (only the SHAPE Q(T)/Q(296) reaches the line-strength
#          scaling, ops/strengths.py).
# q296 = HITRAN molparam reference partition sum (the anchor).  Entries
# marked q296_recalled=True carry a from-memory molparam value (this image
# has no network access): their ABSOLUTE Q may be off at the percent level,
# which cancels exactly in S(T) — register_q_table() installs official
# numbers when available.
_SPECIES: Dict[Tuple[int, int], dict] = {
    # --- H2O (mol 1): light asymmetric top — direct diagonalisation ---
    (1, 1): dict(kind="asym", ABC=(27.8806, 14.5216, 9.2778), sigma=2,
                 spin="h2o", q296=174.58,
                 modes=((3657.1, 1), (1594.7, 1), (3755.9, 1))),
    (1, 2): dict(kind="asym", ABC=(27.7880, 14.5187, 9.2648), sigma=2,
                 spin="h2o", q296=176.05,
                 modes=((3649.7, 1), (1588.3, 1), (3741.6, 1))),
    (1, 3): dict(kind="asym", ABC=(27.8320, 14.5200, 9.2710), sigma=2,
                 spin="h2o", q296=1052.14,
                 modes=((3653.1, 1), (1591.3, 1), (3748.3, 1))),
    (1, 4): dict(kind="asym", ABC=(23.4140, 9.1030, 6.4060), sigma=1,
                 q296=864.74,
                 modes=((2723.7, 1), (1403.5, 1), (3707.5, 1))),

    # --- CO2 (mol 2): linear, exact J sum.  sigma=2 for symmetric isos.
    # ν2 (bending, the only thermally active mode <500 K) per isotopologue;
    # rare-iso ν1/ν3 are mass-scaled estimates (sub-0.05% effect below 400 K).
    (2, 1): dict(kind="linear", B=0.39022, sigma=2, q296=286.09,
                 modes=((1333.0, 1), (667.4, 2), (2349.1, 1))),
    (2, 2): dict(kind="linear", B=0.39024, sigma=2, q296=576.64,
                 modes=((1370.0, 1), (648.5, 2), (2283.5, 1))),
    (2, 3): dict(kind="linear", B=0.36818, sigma=1, q296=607.81,
                 modes=((1365.8, 1), (662.4, 2), (2332.1, 1))),
    (2, 4): dict(kind="linear", B=0.37867, sigma=1, q296=3542.61,
                 modes=((1345.6, 1), (664.7, 2), (2340.0, 1))),
    (2, 5): dict(kind="linear", B=0.36820, sigma=1, q296=1166.54,
                 modes=((1352.0, 1), (643.3, 2), (2265.9, 1))),
    (2, 6): dict(kind="linear", B=0.37870, sigma=1, q296=7135.78,
                 modes=((1360.0, 1), (645.7, 2), (2274.0, 1))),
    (2, 7): dict(kind="linear", B=0.34671, sigma=2, q296=323.42,
                 modes=((1365.0, 1), (657.3, 2), (2314.2, 1))),
    (2, 8): dict(kind="linear", B=0.35723, sigma=1, q296=3766.58,
                 modes=((1355.0, 1), (659.7, 2), (2322.0, 1))),
    (2, 9): dict(kind="linear", B=0.36800, sigma=2, q296=10971.57,
                 modes=((1345.0, 1), (662.1, 2), (2330.0, 1))),
    (2, 10): dict(kind="linear", B=0.34680, sigma=2, q296=652.24,
                  modes=((1347.0, 1), (638.0, 2), (2231.0, 1))),
    (2, 11): dict(kind="linear", B=0.35730, sigma=1, q296=7595.04,
                  modes=((1351.0, 1), (640.4, 2), (2239.0, 1))),
    (2, 12): dict(kind="linear", B=0.36810, sigma=1, q296=22120.47,
                  modes=((1355.0, 1), (642.8, 2), (2247.0, 1))),

    # --- O3 (mol 3): heavy asymmetric top — classical rotor is exact here
    (3, 1): dict(kind="classical", ABC=(3.5537, 0.44527, 0.39479), sigma=2,
                 q296=3483.71,
                 modes=((1103.1, 1), (700.9, 1), (1042.1, 1))),
    (3, 2): dict(kind="classical", ABC=(3.5230, 0.42350, 0.37680), sigma=1,
                 q296=7465.68,
                 modes=((1090.4, 1), (684.6, 1), (1025.6, 1))),
    (3, 3): dict(kind="classical", ABC=(3.3870, 0.44480, 0.39230), sigma=1,
                 q296=3647.08,
                 modes=((1074.3, 1), (693.3, 1), (1008.5, 1))),

    # --- N2O (mol 4): linear, sigma=1 (N-N-O has no symmetry) ---
    (4, 1): dict(kind="linear", B=0.41901, sigma=1, q296=4984.90,
                 modes=((1284.9, 1), (588.8, 2), (2223.8, 1))),
    (4, 2): dict(kind="linear", B=0.41910, sigma=1, q296=3362.01,
                 modes=((1280.4, 1), (575.4, 2), (2177.7, 1))),
    (4, 3): dict(kind="linear", B=0.40486, sigma=1, q296=3458.58,
                 modes=((1264.7, 1), (586.0, 2), (2220.1, 1))),
    (4, 4): dict(kind="linear", B=0.39570, sigma=1, q296=5314.74,
                 modes=((1246.9, 1), (584.2, 2), (2216.7, 1))),

    # --- CO (mol 5): linear diatomic — exact J sum ---
    (5, 1): dict(kind="linear", B=1.93128, sigma=1, q296=107.42,
                 modes=((2143.3, 1),)),
    (5, 2): dict(kind="linear", B=1.84604, sigma=1, q296=224.69,
                 modes=((2096.1, 1),)),
    (5, 3): dict(kind="linear", B=1.83797, sigma=1, q296=112.77,
                 modes=((2092.1, 1),)),
    (5, 4): dict(kind="linear", B=1.88250, sigma=1, q296=661.17,
                 modes=((2112.0, 1),)),
    (5, 5): dict(kind="linear", B=1.74719, sigma=1, q296=236.44,
                 modes=((2044.1, 1),)),
    (5, 6): dict(kind="linear", B=1.79210, sigma=1, q296=1384.66,
                 modes=((2064.0, 1),)),

    # --- CH4 (mol 6): spherical top — direct (2J+1)^2 sum ---
    (6, 1): dict(kind="spherical", B=5.2412, sigma=12, q296=590.48,
                 modes=((2917.0, 1), (1533.3, 2), (3019.5, 3), (1310.8, 3))),
    (6, 2): dict(kind="spherical", B=5.2412, sigma=12, q296=1180.82,
                 modes=((2915.4, 1), (1533.5, 2), (3009.5, 3), (1302.8, 3))),
    (6, 3): dict(kind="spherical", B=3.9300, sigma=6, q296=4794.73,
                 modes=((2945.0, 1), (1533.0, 2), (3017.0, 3), (1471.0, 2),
                        (1155.0, 2), (2200.0, 1), (1033.0, 1))),

    # --- O2 (mol 7): linear, triplet-Sigma ground state (constant factor 3
    # absorbed by the anchor); HITRAN iso order 66, 68, 67 ---
    (7, 1): dict(kind="linear", B=1.43768, sigma=2, q296=215.73,
                 modes=((1580.2, 1),)),
    (7, 2): dict(kind="linear", B=1.35780, sigma=1, q296=455.23,
                 modes=((1536.6, 1),)),
    (7, 3): dict(kind="linear", B=1.39661, sigma=1, q296=2658.12,
                 modes=((1558.7, 1),)),

    # --- N2 (mol 22) ---
    (22, 1): dict(kind="linear", B=1.99824, sigma=2, q296=467.10,
                  modes=((2358.6, 1),)),

    # --- HCN (mol 23): linear ---
    (23, 1): dict(kind="linear", B=1.47822, sigma=1, q296=892.20,
                  modes=((2096.8, 1), (713.5, 2), (3311.5, 1))),
    (23, 2): dict(kind="linear", B=1.43999, sigma=1, q296=1830.97,
                  modes=((2063.0, 1), (706.0, 2), (3293.0, 1))),
    (23, 3): dict(kind="linear", B=1.43535, sigma=1, q296=615.28,
                  modes=((2065.0, 1), (711.0, 2), (3305.0, 1))),

    # --- C2H2 (mol 26): linear, 5 modes (2 doubly degenerate bends) ---
    (26, 1): dict(kind="linear", B=1.17664, sigma=2, q296=412.45,
                  modes=((3372.8, 1), (1974.3, 1), (3294.8, 1),
                         (612.9, 2), (730.3, 2))),

    # --- C2H6 (mol 27): near-symmetric top; classical rotor + 18 harmonic
    # modes (the 289 cm-1 torsion treated as harmonic — the dominant
    # approximation; anchored at 296 K) ---
    (27, 1): dict(kind="classical", ABC=(2.671, 0.6630, 0.6630), sigma=6,
                  q296=70882.52,
                  modes=((2954.0, 1), (1388.4, 1), (994.8, 1), (289.0, 1),
                         (2896.0, 1), (1379.2, 1), (2969.0, 2), (1468.1, 2),
                         (1190.0, 2), (2985.0, 2), (1469.0, 2), (821.6, 2))),

    # ------------------------------------------------------------------
    # Round-3 completion (round-2 review item 2): principal
    # isotopologues of every remaining HITRAN molecule, 8-21, 24, 25,
    # 28-55.  Constants are standard published values (NIST diatomic
    # tables / Herzberg / HITRAN documentation) from memory — no network
    # on this image.  q296 anchors marked recalled=True are from-memory
    # HITRAN molparam values (percent-level confidence; the ABSOLUTE Q
    # cancels in S(T), see q_table); entries WITHOUT q296 anchor to the
    # model's own 296 K value (pure model absolute — register official
    # TIPS tables via register_q_table for external consumers).
    # ------------------------------------------------------------------

    # --- NO (mol 8): 2Pi diatomic — spin-orbit doublet in the shape ---
    (8, 1): dict(kind="linear", B=1.67195, sigma=1, q296=1142.13,
                 modes=((1876.1, 1),),
                 elec=((0.0, 2), (119.82, 2))),
    # --- SO2 (mol 9): heavy asymmetric top ---
    (9, 1): dict(kind="classical", ABC=(2.02736, 0.34417, 0.29353), sigma=2,
                 q296=6340.30,
                 modes=((1151.7, 1), (517.9, 1), (1362.1, 1))),
    (9, 2): dict(kind="classical", ABC=(2.02696, 0.33302, 0.28540), sigma=2,
                 q296=6626.35, recalled=True,
                 modes=((1147.0, 1), (513.5, 1), (1345.1, 1))),
    # --- NO2 (mol 10): doublet (constant x2 cancels via anchor) ---
    (10, 1): dict(kind="classical", ABC=(8.00236, 0.43371, 0.41040), sigma=2,
                  q296=13577.48,
                  modes=((1319.8, 1), (749.7, 1), (1616.9, 1))),
    # --- NH3 (mol 11): oblate symmetric top (inversion doubling is a
    # near-constant factor below 500 K — anchored away) ---
    (11, 1): dict(kind="symtop", B=9.9466, X=6.2287, sigma=3, q296=1725.22,
                  modes=((3336.6, 1), (950.0, 1), (3443.6, 2), (1626.8, 2))),
    (11, 2): dict(kind="symtop", B=9.9398, X=6.2270, sigma=3, q296=1153.30,
                  recalled=True,
                  modes=((3335.2, 1), (948.9, 1), (3435.0, 2), (1623.2, 2))),
    # --- HNO3 (mol 12): heavy planar asymmetric top, 9 modes ---
    (12, 1): dict(kind="classical", ABC=(0.43395, 0.40342, 0.20871), sigma=1,
                  q296=213999.0, recalled=True,
                  modes=((3551.0, 1), (1709.0, 1), (1326.0, 1), (1304.0, 1),
                         (879.0, 1), (763.0, 1), (647.0, 1), (580.0, 1),
                         (458.0, 1))),
    # --- OH (mol 13): 2Pi diatomic (inverted SO splitting 139 cm-1) ---
    (13, 1): dict(kind="linear", B=18.5504, sigma=1, q296=80.35,
                  modes=((3569.6, 1),),
                  elec=((0.0, 2), (139.2, 2))),
    # --- Hydrogen halides (mols 14-17): 1Sigma diatomics ---
    (14, 1): dict(kind="linear", B=20.5598, sigma=1, q296=41.47,
                  modes=((3961.4, 1),)),
    (15, 1): dict(kind="linear", B=10.4398, sigma=1, q296=160.65,
                  modes=((2885.9, 1),)),
    (15, 2): dict(kind="linear", B=10.4242, sigma=1, q296=160.89,
                  recalled=True, modes=((2883.8, 1),)),
    (16, 1): dict(kind="linear", B=8.34824, sigma=1, q296=200.17,
                  modes=((2558.5, 1),)),
    (17, 1): dict(kind="linear", B=6.42635, sigma=1, q296=388.99,
                  modes=((2229.6, 1),)),
    # --- ClO (mol 18): 2Pi with large SO splitting ---
    (18, 1): dict(kind="linear", B=0.62345, sigma=1, q296=3274.61,
                  modes=((842.6, 1),),
                  elec=((0.0, 2), (321.77, 2))),
    # --- OCS (mol 19): linear triatomic ---
    (19, 1): dict(kind="linear", B=0.202857, sigma=1, q296=1221.01,
                  modes=((858.9, 1), (520.4, 2), (2062.2, 1))),
    (19, 2): dict(kind="linear", B=0.197910, sigma=1, q296=1253.48,
                  recalled=True,
                  modes=((848.0, 1), (513.0, 2), (2031.0, 1))),
    # --- H2CO (mol 20): light asymmetric top — direct diagonalisation ---
    (20, 1): dict(kind="asym", ABC=(9.40533, 1.29534, 1.13421), sigma=2,
                  q296=2844.53,
                  modes=((2782.5, 1), (1746.0, 1), (1500.2, 1), (1167.3, 1),
                         (2843.3, 1), (1249.1, 1))),
    # --- HOCl (mol 21) ---
    (21, 1): dict(kind="asym", ABC=(20.4636, 0.50368, 0.49159), sigma=1,
                  q296=19274.79,
                  modes=((3609.5, 1), (1238.6, 1), (724.4, 1))),
    # --- CH3Cl (mol 24): prolate symmetric top ---
    (24, 1): dict(kind="symtop", B=0.44340, X=5.09704, sigma=3,
                  q296=57916.12,
                  modes=((2937.4, 1), (1354.9, 1), (732.8, 1), (3039.3, 2),
                         (1452.2, 2), (1017.3, 2))),
    (24, 2): dict(kind="symtop", B=0.43658, X=5.09657, sigma=3,
                  q296=58833.90, recalled=True,
                  modes=((2937.4, 1), (1354.7, 1), (727.0, 1), (3039.3, 2),
                         (1452.1, 2), (1017.1, 2))),
    # --- H2O2 (mol 25): the 254 cm-1 torsion treated harmonic (dominant
    # approximation above ~250 K) ---
    (25, 1): dict(kind="asym", ABC=(10.3560, 0.84853, 0.81258), sigma=2,
                  q296=9847.99,
                  modes=((3599.0, 1), (1395.0, 1), (865.9, 1), (3608.0, 1),
                         (1264.6, 1), (254.0, 1))),
    # --- PH3 (mol 28): oblate symmetric top ---
    (28, 1): dict(kind="symtop", B=4.4523, X=3.919, sigma=3, q296=3249.44,
                  modes=((2321.1, 1), (992.1, 1), (2326.9, 2), (1118.3, 2))),
    # --- COF2 (mol 29) ---
    (29, 1): dict(kind="classical", ABC=(0.39485, 0.39210, 0.19651), sigma=2,
                  q296=70028.43,
                  modes=((1944.0, 1), (963.0, 1), (584.0, 1), (1242.0, 1),
                         (619.0, 1), (774.0, 1))),
    # --- SF6 (mol 30): octahedral spherical top, sigma = 24 ---
    (30, 1): dict(kind="spherical", B=0.09111, sigma=24, q296=1620604.0,
                  recalled=True,
                  modes=((774.0, 1), (642.0, 2), (948.0, 3), (615.0, 3),
                         (524.0, 3), (346.0, 3))),
    # --- H2S (mol 31): light asymmetric top, H2 ortho/para weights ---
    (31, 1): dict(kind="asym", ABC=(10.3662, 9.0162, 8.9697), sigma=2,
                  spin="h2o", q296=505.79,
                  modes=((2614.4, 1), (1182.6, 1), (2628.5, 1))),
    (31, 2): dict(kind="asym", ABC=(10.3630, 9.0120, 8.9660), sigma=2,
                  spin="h2o", q296=504.35, recalled=True,
                  modes=((2614.0, 1), (1181.9, 1), (2627.8, 1))),
    # --- HCOOH (mol 32) ---
    (32, 1): dict(kind="classical", ABC=(2.58541, 0.40210, 0.34707), sigma=1,
                  q296=39132.76,
                  modes=((3570.0, 1), (2943.0, 1), (1770.0, 1), (1387.0, 1),
                         (1229.0, 1), (1105.0, 1), (1033.0, 1), (638.0, 1),
                         (625.0, 1))),
    # --- HO2 (mol 33): doublet (constant x2 anchored away) ---
    (33, 1): dict(kind="asym", ABC=(20.3565, 1.11789, 1.05629), sigma=1,
                  q296=4300.39,
                  modes=((3436.2, 1), (1391.8, 1), (1097.6, 1))),
    # --- O (mol 34): atomic oxygen — 3P fine structure only ---
    (34, 1): dict(kind="atom", sigma=1, q296=6.72,
                  elec=((0.0, 5), (158.265, 3), (226.977, 1))),
    # --- ClONO2 (mol 35): heavy; the 121 cm-1 torsion dominates the shape.
    # 9 of 12 fundamentals recalled; the 3 omitted are >1200 cm-1 (sub-0.1%
    # below 400 K) ---
    (35, 1): dict(kind="classical", ABC=(0.41014, 0.09219, 0.07546), sigma=1,
                  q296=4790836.0, recalled=True,
                  modes=((1735.0, 1), (1292.0, 1), (809.0, 1), (780.0, 1),
                         (711.0, 1), (560.0, 1), (434.0, 1), (270.0, 1),
                         (121.0, 1))),
    (35, 2): dict(kind="classical", ABC=(0.40610, 0.09090, 0.07430), sigma=1,
                  q296=4910749.0, recalled=True,
                  modes=((1735.0, 1), (1292.0, 1), (807.0, 1), (777.0, 1),
                         (709.0, 1), (556.0, 1), (432.0, 1), (269.0, 1),
                         (120.0, 1))),
    # --- NO+ (mol 36): closed-shell diatomic ion ---
    (36, 1): dict(kind="linear", B=1.99753, sigma=1, q296=311.69,
                  modes=((2344.0, 1),)),
    # --- HOBr (mol 37) ---
    (37, 1): dict(kind="asym", ABC=(20.474, 0.42826, 0.41950), sigma=1,
                  q296=28339.38, recalled=True,
                  modes=((3614.9, 1), (1162.6, 1), (620.2, 1))),
    # --- C2H4 (mol 38): sigma = 4 (D2h), 12 modes ---
    (38, 1): dict(kind="classical", ABC=(4.86462, 1.00106, 0.82804), sigma=4,
                  q296=11041.54,
                  modes=((3026.0, 1), (1623.0, 1), (1342.0, 1), (1023.0, 1),
                         (3103.0, 1), (1236.0, 1), (949.0, 1), (943.0, 1),
                         (3106.0, 1), (826.0, 1), (2989.0, 1), (1444.0, 1))),
    # --- CH3OH (mol 39): the ~270 cm-1 hindered internal rotation treated
    # as a harmonic mode (dominant approximation; anchored) ---
    (39, 1): dict(kind="classical", ABC=(4.2537, 0.82338, 0.79256), sigma=1,
                  q296=70569.92, recalled=True,
                  modes=((3681.0, 1), (3000.0, 1), (2960.0, 1), (2844.0, 1),
                         (1477.0, 2), (1455.0, 1), (1345.0, 1), (1165.0, 1),
                         (1060.0, 1), (1033.0, 1), (270.0, 1))),
    # --- CH3Br (mol 40) ---
    (40, 1): dict(kind="symtop", B=0.31916, X=5.1804, sigma=3,
                  q296=83051.98, recalled=True,
                  modes=((2935.0, 1), (1305.9, 1), (611.0, 1), (3056.0, 2),
                         (1442.8, 2), (954.8, 2))),
    (40, 2): dict(kind="symtop", B=0.31748, X=5.1804, sigma=3,
                  q296=83395.21, recalled=True,
                  modes=((2935.0, 1), (1305.9, 1), (608.0, 1), (3056.0, 2),
                         (1442.8, 2), (954.0, 2))),
    # --- CH3CN (mol 41): the 362 cm-1 degenerate CCN bend dominates ---
    (41, 1): dict(kind="symtop", B=0.30684, X=5.2470, sigma=3,
                  q296=88672.19, recalled=True,
                  modes=((2954.0, 1), (2267.0, 1), (1385.0, 1), (920.0, 1),
                         (3009.0, 2), (1448.0, 2), (1041.0, 2), (362.0, 2))),
    # --- CF4 (mol 42): tetrahedral, sigma = 12 ---
    (42, 1): dict(kind="spherical", B=0.19235, sigma=12, q296=121166.4,
                  recalled=True,
                  modes=((908.4, 1), (435.0, 2), (1283.0, 3), (631.2, 3))),
    # --- C4H2 (mol 43): diacetylene, 4 doubly degenerate bends ---
    (43, 1): dict(kind="linear", B=0.146395, sigma=2, q296=9818.97,
                  recalled=True,
                  modes=((3332.0, 1), (2189.0, 1), (872.0, 1), (3333.0, 1),
                         (2022.0, 1), (628.0, 2), (482.0, 2), (630.0, 2),
                         (220.0, 2))),
    # --- HC3N (mol 44): cyanoacetylene ---
    (44, 1): dict(kind="linear", B=0.151739, sigma=1, q296=24786.84,
                  recalled=True,
                  modes=((3327.0, 1), (2274.0, 1), (2079.0, 1), (878.0, 1),
                         (663.0, 2), (499.0, 2), (223.0, 2))),
    # --- H2 (mol 45): explicit para/ortho J-parity weights (B ~ 59 cm-1
    # puts the o/p alternation in the shape up to ~400 K) ---
    (45, 1): dict(kind="linear", B=59.3344, sigma=1, spin="h2", q296=7.67,
                  modes=((4161.2, 1),)),
    (45, 2): dict(kind="linear", B=44.6658, sigma=1, q296=29.87,
                  recalled=True, modes=((3632.2, 1),)),
    # --- CS (mol 46) ---
    (46, 1): dict(kind="linear", B=0.817996, sigma=1, q296=253.62,
                  modes=((1272.2, 1),)),
    # --- SO3 (mol 47): planar D3h, sigma = 6 ---
    (47, 1): dict(kind="classical", ABC=(0.34854, 0.34854, 0.17427), sigma=6,
                  q296=7783.30, recalled=True,
                  modes=((1064.9, 1), (497.6, 1), (1391.5, 2), (530.1, 2))),
    # --- C2N2 (mol 48): cyanogen ---
    (48, 1): dict(kind="linear", B=0.15708, sigma=2, q296=15582.44,
                  recalled=True,
                  modes=((2330.0, 1), (845.0, 1), (2158.0, 1), (503.0, 2),
                         (234.0, 2))),
    # --- COCl2 (mol 49): phosgene ---
    (49, 1): dict(kind="classical", ABC=(0.26450, 0.11613, 0.08066), sigma=2,
                  q296=1480324.0, recalled=True,
                  modes=((1827.0, 1), (849.0, 1), (580.0, 1), (569.0, 1),
                         (440.0, 1), (285.0, 1))),
    (49, 2): dict(kind="classical", ABC=(0.26160, 0.11332, 0.07905), sigma=1,
                  q296=3043326.0, recalled=True,
                  modes=((1827.0, 1), (845.0, 1), (578.0, 1), (564.0, 1),
                         (437.0, 1), (283.0, 1))),
    # --- SO (mol 50): 3Sigma- (spin-triplet factor constant; the ~10 cm-1
    # spin splitting is sub-0.1% in shape above 100 K) ---
    (50, 1): dict(kind="linear", B=0.72082, sigma=1, q296=848.81,
                  recalled=True, modes=((1136.9, 1),)),
    # --- CH3F (mol 51) — model-absolute (no molparam recall) ---
    (51, 1): dict(kind="symtop", B=0.85179, X=5.1820, sigma=3,
                  modes=((2930.0, 1), (1464.0, 1), (1048.6, 1), (3006.0, 2),
                         (1467.0, 2), (1182.7, 2))),
    # --- GeH4 (mol 52): tetrahedral — model-absolute ---
    (52, 1): dict(kind="spherical", B=2.696, sigma=12,
                  modes=((2106.0, 1), (931.0, 2), (2114.0, 3), (819.0, 3))),
    # --- CS2 (mol 53) ---
    (53, 1): dict(kind="linear", B=0.10910, sigma=2, q296=1352.60,
                  recalled=True,
                  modes=((658.0, 1), (397.0, 2), (1535.0, 1))),
    # --- CH3I (mol 54) — model-absolute ---
    (54, 1): dict(kind="symtop", B=0.25022, X=5.1742, sigma=3,
                  modes=((2933.0, 1), (1252.0, 1), (533.0, 1), (3060.0, 2),
                         (1436.0, 2), (882.0, 2))),
    # --- NF3 (mol 55): oblate symmetric top — model-absolute ---
    (55, 1): dict(kind="symtop", B=0.35625, X=0.19509, sigma=3,
                  modes=((1032.0, 1), (647.0, 1), (907.0, 2), (492.0, 2))),
}

# User-registered override tables: (mol, iso) -> Q on T_GRID.
_REGISTERED: Dict[Tuple[int, int], np.ndarray] = {}
# Computed-table cache (the asymmetric-top diagonalisation is host work we
# only want to pay once per process per isotopologue).
_CACHE: Dict[Tuple[int, int], np.ndarray] = {}


# ---------------------------------------------------------------------------
# Rotational partition sums
# ---------------------------------------------------------------------------

def _j_conv(B: float) -> int:
    """J needed for 1e-8-relative convergence of a rotational sum at
    1500 K: the tail beyond J is ~exp(-c2 B J^2 / T), so demand
    c2 B J^2 / 1500 >= 32  =>  J >= sqrt(32 * 1500 / (1.44 B)) ~ 183/sqrt(B)
    (round-3 code-review: the earlier 40/sqrt(B) heuristic truncated
    SF6/NF3-class sums by 1-7% at the grid top, biasing the anchored SHAPE
    that line-strength scaling consumes)."""
    return int(np.ceil(183.0 / np.sqrt(max(B, 1e-3)))) + 20


def _q_rot_linear(B: float, sigma: int, T: np.ndarray,
                  j_max: int = 400, spin=None) -> np.ndarray:
    """Exact rigid-rotor sum  (1/sigma) * sum_J (2J+1) exp(-c2 B J(J+1)/T).

    Converged on the full grid for B >= 0.3 cm-1 at j_max=400 (tail term
    < 1e-12 of the sum at 1500 K); for diatomics (B ~ 2) it converges by
    J ~ 150.  The sigma approximation to nuclear-spin statistics is exact
    here to O(exp(-c2 B / T_min)) relative — negligible for all registered
    linear molecules at T >= 20 K, EXCEPT H2-likes: ``spin="h2"`` applies
    the explicit para/ortho J-parity weights (1 even : 3 odd), which at
    H2's B ~ 61 cm-1 dominate Q below ~300 K.
    """
    j_max = max(j_max, _j_conv(B))
    J = np.arange(j_max + 1, dtype=np.float64)
    E = B * J * (J + 1.0)                                   # [J]
    g = 2.0 * J + 1.0
    if spin == "h2":
        g = g * np.where(J % 2 == 1, 3.0, 1.0)
        sigma = 1
    return (g[None, :] * np.exp(-C2 * E[None, :] / T[:, None])).sum(1) / sigma


def _q_rot_symtop(B: float, X: float, sigma: int, T: np.ndarray,
                  j_max: int = 120) -> np.ndarray:
    """Direct symmetric-top sum

        (1/sigma) sum_J sum_{K=-J..J} (2J+1) exp(-c2 [B J(J+1) + (X-B) K^2]/T)

    with X = A (prolate) or C (oblate); ``j_max`` is raised to the
    1500 K convergence bound :func:`_j_conv` of the smallest constant.
    The uniform 1/sigma rule carries the usual O(exp(-c2 B/T_min))
    nuclear-spin error, anchored away at 296 K.
    """
    j_max = max(j_max, _j_conv(min(B, abs(X))))
    out = np.zeros_like(T)
    for J in range(j_max + 1):
        K = np.arange(-J, J + 1, dtype=np.float64)
        E = B * J * (J + 1.0) + (X - B) * K ** 2
        out += (2.0 * J + 1.0) * np.exp(-C2 * E[None, :] / T[:, None]).sum(1)
    return out / sigma


def _q_rot_spherical(B: float, sigma: int, T: np.ndarray,
                     j_max: int = 200) -> np.ndarray:
    """Spherical-top sum  (1/sigma) * sum_J (2J+1)^2 exp(-c2 B J(J+1)/T);
    ``j_max`` raised to the 1500 K bound :func:`_j_conv` (SF6's B = 0.091
    needs J ~ 620 — the old fixed 200 was ~7% low at the grid top)."""
    j_max = max(j_max, _j_conv(B))
    J = np.arange(j_max + 1, dtype=np.float64)
    E = B * J * (J + 1.0)
    g = (2.0 * J + 1.0) ** 2
    return (g[None, :] * np.exp(-C2 * E[None, :] / T[:, None])).sum(1) / sigma


def _asym_top_levels(A: float, B: float, C: float, j_max: int):
    """Rigid asymmetric-rotor energy levels by direct diagonalisation.

    Watson-A reduced rigid rotor in the prolate symmetric-top basis |J, K>:
      <K|H|K>   = ((B+C)/2) (J(J+1) - K^2) + A K^2
      <K|H|K+2> = ((B-C)/4) sqrt[(J(J+1)-K(K+1)) (J(J+1)-(K+1)(K+2))]
    Returns (E, ka_plus_kc_parity) flattened over J; each level carries the
    (2J+1) M-degeneracy separately (returned as g).
    """
    Es, gs, par = [], [], []
    for J in range(j_max + 1):
        K = np.arange(-J, J + 1, dtype=np.float64)
        n = 2 * J + 1
        jj = J * (J + 1.0)
        H = np.zeros((n, n), dtype=np.float64)
        H[np.arange(n), np.arange(n)] = 0.5 * (B + C) * (jj - K ** 2) + A * K ** 2
        for i in range(n - 2):
            k = K[i]
            off = 0.25 * (B - C) * np.sqrt(
                (jj - k * (k + 1.0)) * (jj - (k + 1.0) * (k + 2.0)))
            H[i, i + 2] = H[i + 2, i] = off
        E = np.linalg.eigvalsh(H)                            # ascending
        # Sorted ascending, levels are J_{Ka,Kc} with (Ka,Kc) = (0,J), (1,J),
        # (1,J-1), (2,J-1), ... : Ka = (i+1)//2, Kc = J - i//2.
        i = np.arange(n)
        ka = (i + 1) // 2
        kc = J - i // 2
        Es.append(E)
        gs.append(np.full(n, 2 * J + 1.0))
        par.append((ka + kc) % 2)
    return np.concatenate(Es), np.concatenate(gs), np.concatenate(par)


def _q_rot_asym(ABC, sigma: int, spin, T: np.ndarray,
                j_max: int = 64) -> np.ndarray:
    """Direct asymmetric-top sum with nuclear-spin weights.

    ``spin="h2o"`` applies the H2 ortho/para weights: para (Ka+Kc even,
    includes the 0_00 ground state) weight 1, ortho (Ka+Kc odd) weight 3 —
    the statistics that matter for H2O below ~60 K and that the classical
    1/sigma rule misses.  Any other value uses the uniform 1/sigma rule on
    the exact level set.
    """
    A, B, C = ABC
    E, g, parity = _asym_top_levels(A, B, C, j_max)
    if spin == "h2o":
        w = np.where(parity == 1, 3.0, 1.0)  # ortho : para = 3 : 1
        gw = g * w / 4.0   # normalised to match the 1/sigma high-T limit
    else:
        gw = g / sigma
    return (gw[None, :] * np.exp(-C2 * E[None, :] / T[:, None])).sum(1)


def _q_rot_classical(ABC, sigma: int, T: np.ndarray) -> np.ndarray:
    """Classical asymmetric rotor — used only where c2*max(A,B,C)/T_min is
    small enough that the error is below the anchor's own precision."""
    A, B, C = ABC
    return (np.sqrt(np.pi) / sigma) * np.sqrt((T / C2) ** 3 / (A * B * C))


def _q_vib(modes, T: np.ndarray) -> np.ndarray:
    q = np.ones_like(T)
    for omega, d in modes:
        q = q * (1.0 - np.exp(-C2 * omega / T)) ** (-float(d))
    return q


def _q_elec(elec, T: np.ndarray) -> np.ndarray:
    """Low-lying electronic/spin-orbit/fine-structure partition factor."""
    q = np.zeros_like(T)
    for E, g in elec:
        q = q + g * np.exp(-C2 * E / T)
    return q


def _q_model(spec: dict, T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, dtype=np.float64)
    kind = spec["kind"]
    if kind == "linear":
        q_rot = _q_rot_linear(spec["B"], spec["sigma"], T,
                              spin=spec.get("spin"))
    elif kind == "symtop":
        q_rot = _q_rot_symtop(spec["B"], spec["X"], spec["sigma"], T)
    elif kind == "spherical":
        q_rot = _q_rot_spherical(spec["B"], spec["sigma"], T)
    elif kind == "asym":
        q_rot = _q_rot_asym(spec["ABC"], spec["sigma"], spec.get("spin"), T)
    elif kind == "classical":
        q_rot = _q_rot_classical(spec["ABC"], spec["sigma"], T)
    elif kind == "atom":
        q_rot = np.ones_like(T)
    else:  # pragma: no cover
        raise ValueError(f"unknown rotor kind {kind!r}")
    q = q_rot * _q_vib(spec.get("modes", ()), T)
    if "elec" in spec:
        q = q * _q_elec(spec["elec"], T)
    return q


# HITRAN molparam Q(296 K) anchors, exposed for tests / external use.
# Model-absolute entries (no recalled molparam value) get their own model's
# 296 K value lazily via q_of_T; they are omitted here so consumers can see
# which anchors are external.
Q296: Dict[Tuple[int, int], float] = {
    k: v["q296"] for k, v in _SPECIES.items() if "q296" in v
}


def register_q_table(mol_id: int, iso_id: int, temps: np.ndarray, q: np.ndarray) -> None:
    """Register an external (e.g. official TIPS) Q(T) table; it overrides the
    built-in anchored quantum-sum model for this isotopologue after
    re-interpolation onto the shared ``T_GRID``."""
    _REGISTERED[(mol_id, iso_id)] = np.interp(T_GRID, np.asarray(temps), np.asarray(q))
    _CACHE.pop((mol_id, iso_id), None)


def q_of_T(mol_id: int, iso_id: int, T) -> np.ndarray:
    """Host-side Q(T) evaluation (numpy).  Warns when T falls outside the
    table grid (the device path clamps silently for jit-ability — a wrong-Q
    line is a silent physics error, so the host path is loud; the review
    round-1 weak item 5)."""
    T_arr = np.asarray(T, dtype=np.float64)
    if np.any(T_arr < T_GRID[0]) or np.any(T_arr > T_GRID[-1]):
        warnings.warn(
            f"Q(T) evaluated outside the table grid "
            f"[{T_GRID[0]:.0f}, {T_GRID[-1]:.0f}] K for molecule {mol_id} "
            f"iso {iso_id} (T range [{T_arr.min():.1f}, {T_arr.max():.1f}] K); "
            f"values are clamped to the grid edge.", stacklevel=2)
    tab = q_table(mol_id, iso_id)
    return np.interp(T_arr, T_GRID, tab)


def q_table(mol_id: int, iso_id: int) -> np.ndarray:
    key = (mol_id, iso_id)
    if key in _REGISTERED:
        return _REGISTERED[key]
    if key in _CACHE:
        return _CACHE[key]
    spec = _SPECIES.get(key)
    if spec is None:
        # Fall back to the main isotopologue's SHAPE (Q(T)/Q296); rare-iso
        # shapes differ at the sub-percent level, but this is still a
        # physics approximation the user should hear about (the review
        # round-1 weak item 5).
        spec = _SPECIES.get((mol_id, 1))
        if spec is not None:
            warnings.warn(
                f"No partition-function data for molecule {mol_id} iso "
                f"{iso_id}; using the main isotopologue's Q(T) shape. "
                f"Register an official table via tips.register_q_table().",
                stacklevel=2)
    if spec is None:
        raise KeyError(f"No partition-function model for molecule {mol_id} iso {iso_id}")
    model = _q_model(spec, T_GRID)
    if "q296" in spec:
        anchor = spec["q296"] / float(np.interp(T_REF, T_GRID, model))
    else:
        anchor = 1.0   # model-absolute entry (see _SPECIES header note)
    tab = model * anchor
    _CACHE[key] = tab
    return tab


def pack_q_tables(species: list) -> np.ndarray:
    """Pack per-(mol, iso) tables into a dense (n_species, n_T) array for
    device staging.  ``species`` is a list of (mol_id, iso_id)."""
    return np.stack([q_table(m, i) for (m, i) in species], axis=0)
