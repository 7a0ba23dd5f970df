"""Full-HITRAN molecule registry (round-1 review item 6).

Masses and abundances are COMPUTED from atomic isotope tables; these tests
pin them against published HITRAN molparam values and assert the loud
failure on unknown species.
"""

import numpy as np
import pytest

from spectrobot_tpu.data.hitran import _attach_mass
from spectrobot_tpu.data.molparams import MOLECULES, NAME_TO_ID, molecule_by_name

# (mol, iso, molparam mass [amu], molparam abundance) — HITRAN molparam.
_MOLPARAM = [
    (1, 1, 18.010565, 0.997317),
    (1, 4, 19.016740, 3.10693e-4),
    (2, 1, 43.989830, 0.984204),
    (2, 2, 44.993185, 1.10574e-2),
    (2, 3, 45.994076, 3.94707e-3),
    (2, 7, 47.998322, 3.95734e-6),
    (3, 1, 47.984745, 0.992901),
    (4, 1, 44.001062, 0.990333),
    (5, 1, 27.994915, 0.986544),
    (5, 2, 28.998270, 1.10836e-2),
    (6, 1, 16.031300, 0.988274),
    (6, 3, 17.037475, 6.15751e-4),
    (7, 1, 31.989830, 0.995262),
    (15, 1, 35.976678, 0.757587),
    (22, 1, 28.006148, 0.992687),
    (23, 1, 27.010899, 0.985114),
    (26, 1, 26.015650, 0.977599),
    (27, 1, 30.046950, 0.976990),
    (45, 1, 2.015650, 0.999688),
]


def test_registry_covers_full_hitran_numbering():
    assert set(MOLECULES) == set(range(1, 56))
    n_iso = sum(len(m.isotopologues) for m in MOLECULES.values())
    assert n_iso >= 120
    for m in MOLECULES.values():
        # iso ids are contiguous from 1 and every entry is physical
        assert sorted(m.isotopologues) == list(range(1, len(m.isotopologues) + 1))
        for iso in m.isotopologues.values():
            assert 1.0 < iso.mass_amu < 300.0 or m.name == "H2"
            assert 0.0 < iso.abundance <= 1.0


def test_masses_and_abundances_match_molparam():
    for mol, iso, mass, ab in _MOLPARAM:
        got = MOLECULES[mol].isotopologues[iso]
        # masses: computed from AME atomic masses; molparam prints a few
        # 1e-4-level differences for D-substituted species
        assert abs(got.mass_amu - mass) < 2e-4, (mol, iso, got.mass_amu)
        assert abs(got.abundance - ab) / ab < 1.5e-3, (mol, iso, got.abundance)


def test_abundances_sum_near_unity():
    """Isotopologue abundances of well-covered molecules sum to ~1."""
    for name in ("H2O", "CO2", "CO", "O2"):
        m = molecule_by_name(name)
        s = sum(i.abundance for i in m.isotopologues.values())
        assert 0.999 < s < 1.001, (name, s)


def test_name_lookup():
    assert molecule_by_name("ch4").mol_id == 6
    assert NAME_TO_ID["NF3"] == 55
    assert MOLECULES[52].name == "GeH4"


def test_attach_mass_known_species():
    cols = {"mol_id": np.array([2, 2, 5]), "iso_id": np.array([1, 3, 2])}
    out = _attach_mass(dict(cols))
    np.testing.assert_allclose(
        out["mass_amu"], [43.98983, 45.994076, 28.99827], atol=2e-4)


def test_attach_mass_unknown_species_raises():
    with pytest.raises(KeyError, match="molecule 99"):
        _attach_mass({"mol_id": np.array([99]), "iso_id": np.array([1])})
    with pytest.raises(KeyError, match="isotopologue 13"):
        _attach_mass({"mol_id": np.array([2]), "iso_id": np.array([13])})
