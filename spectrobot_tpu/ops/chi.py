"""Sub-Lorentzian wing-correction (chi) factors (round-4 review item 9).

CO2-CO2 line wings fall off FASTER than Lorentzian; Mars/Venus CO2
radiative-transfer codes multiply the far wing by an empirical chi factor
(Perrin & Hartmann 1989-style piecewise exponentials).  Whether the
reference (fedef17/SpectRobot) ships one is unverifiable while the mount
is empty (SURVEY.md section 0.1.5); this hook is the cheap insurance the
round-4 review asked for: default OFF is bit-identical, and one
literature-parameterised profile ships for the flagship CO2 workload.

Form: within the production wing cutoff (<= 30 cm^-1) only the
FIRST Perrin-Hartmann segment applies, so chi reduces to a single
per-line exponential slope

    chi(|dnu|) = exp(-b(T) * max(|dnu| - DELTA1, 0)),   DELTA1 = 3 cm^-1

with the temperature-dependent slope b(T) evaluated per line from each
(ray, layer) state's per-species Curtis-Godson temperature in the stage-1
prologue (ops.opacity.line_kernel_inputs) — b rides the kernel as one more
per-line array (0 = chi off for that line, exactly 1.0), so per-species
masking costs nothing and the T dependence is exact per state.

Jacobian convention (documented limitation): the analytic basis tangent
AND the custom-VJP transpose treat chi as CONSTANT (frozen-chi) — exact
for amplitude/width/y derivatives (chi scales all four basis rows), and
drops only the d(chi)/d(nu_c) and d(chi)/dT-through-b terms, which are
O(b/scale_x) ~ 1e-4 of the retained line-position term (b ~ 0.01-0.09
per cm^-1 vs scale_x ~ 1e3 per cm^-1).  The LUT tier is the exception:
chi bakes into the table, so its T dependence differentiates EXACTLY
through the table interpolation.

Coverage: both engines (jnp scan + all Pallas kernels incl. the fused
basis and its transpose), the mesh bodies (owner + halo hops), the LUT
build, and the CLI (`lines.chi`).

Coefficients for "co2_mars": the first-segment slope of the Perrin &
Hartmann (1989, JQSRT 42, 311) CO2-CO2 chi factor,
b1(T) = alpha1 + beta1 exp(-eps1 T) with alpha1 = 0.0888, beta1 = -0.160,
eps1 = 0.00410 — the segment boundaries are 3 and 30 cm^-1, so with the
default 25 cm^-1 cutoff the single-segment form IS the full P&H factor.
Validate against the reference's own chi treatment per SURVEY.md 0.1.5
when the mount is populated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

# First-segment knot [cm^-1]: chi = 1 inside |dnu| <= DELTA1.
CHI_DELTA1 = 3.0

# The single-slope form is exact only while the wing cutoff stays inside
# the second P&H segment boundary.
CHI_MAX_CUTOFF = 30.0


class ChiProfile(NamedTuple):
    """One sub-Lorentzian wing profile: applies to ``species`` (molecule
    name); slope b(T) = max(alpha + beta * exp(-eps * T), 0) [1/cm^-1]."""
    species: str
    alpha: float
    beta: float
    eps: float

    def slope(self, T):
        """b(T) >= 0 for scalar or array T."""
        return jnp.maximum(self.alpha + self.beta * jnp.exp(-self.eps * T),
                           0.0)


CHI_PROFILES = {
    # Perrin & Hartmann (1989) CO2-CO2, first segment (3-30 cm^-1).
    "co2_mars": ChiProfile("CO2", 0.0888, -0.160, 0.00410),
}


def chi_slopes_for_lines(profile: Optional[ChiProfile], lines, T_line):
    """Per-line chi slopes [L] for a DeviceLines batch at per-line CG
    temperatures ``T_line`` (0 where the profile does not apply).

    ``lines.mol_id_per_line`` (int per line) selects the species; the
    profile's species name is resolved through data.molparams.
    """
    if profile is None:
        return None
    from spectrobot_tpu.data.molparams import molecule_by_name
    mol_id = molecule_by_name(profile.species).mol_id
    mask = (lines.mol_of_line == mol_id)
    return jnp.where(mask, profile.slope(T_line), 0.0)


def chi_factor_np(dnu_abs, b):
    """Float64 NumPy chi factor for oracles/tests (same formula)."""
    return np.exp(-np.asarray(b) * np.maximum(np.asarray(dnu_abs)
                                              - CHI_DELTA1, 0.0))
