"""Non-LTE vibrational level registry and populations (C7, SURVEY.md).

The reference (fedef17/SpectRobot ``spect_classes`` Level/Molec/IsoMolec
[SURVEY.md 1.2]) matches lines to vibrational levels through quanta strings
and carries prescribed vibrational-temperature profiles.  Design
(SURVEY.md 8.4 hard part 4): ALL string matching happens host-side, once,
producing integer ``level_upper``/``level_lower`` indices on the line list;
the device sees only a dense ``(n_levels, n_layers)`` vibrational-temperature
array and computes population ratios

    r(level, layer) = exp(-c2 E_level (1/T_vib - 1/T_kin))

plus the per-line weights of ops/planck.py.  Unmatched lines (index -1) get
r_u = r_l = 1 and therefore reduce exactly to LTE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.constants import C2
from spectrobot_tpu.data.hitran import LineList
from spectrobot_tpu.ops.strengths import DeviceLines


@dataclasses.dataclass
class LevelRegistry:
    """Host-side registry of vibrational levels keyed by
    (mol_id, iso_id, global-quanta string)."""

    keys: List[Tuple[int, int, str]] = dataclasses.field(default_factory=list)
    energies_cm1: List[float] = dataclasses.field(default_factory=list)
    _index: Dict[Tuple[int, int, str], int] = dataclasses.field(default_factory=dict)

    def add(self, mol_id: int, iso_id: int, quanta: str, energy_cm1: float) -> int:
        key = (mol_id, iso_id, quanta.strip())
        if key in self._index:
            return self._index[key]
        idx = len(self.keys)
        self.keys.append(key)
        self.energies_cm1.append(float(energy_cm1))
        self._index[key] = idx
        return idx

    def lookup(self, mol_id: int, iso_id: int, quanta: str) -> int:
        return self._index.get((mol_id, iso_id, quanta.strip()), -1)

    @property
    def n_levels(self) -> int:
        return len(self.keys)


def match_lines_to_levels(ll: LineList, registry: LevelRegistry) -> LineList:
    """Annotate a LineList with level indices by global-quanta matching
    (host-side string work; SURVEY.md C7).  Returns the same list with
    ``level_upper``/``level_lower`` filled (-1 where unmatched)."""
    if ll.quanta_global_u is None:
        return ll
    up = np.array([registry.lookup(int(m), int(i), q)
                   for m, i, q in zip(ll.mol_id, ll.iso_id, ll.quanta_global_u)],
                  dtype=np.int32)
    lo = np.array([registry.lookup(int(m), int(i), q)
                   for m, i, q in zip(ll.mol_id, ll.iso_id, ll.quanta_global_l)],
                  dtype=np.int32)
    ll.level_upper[:] = up
    ll.level_lower[:] = lo
    return ll


def registry_from_linelist(ll: LineList) -> LevelRegistry:
    """Build a registry from the quanta present in a line list, assigning
    level energies from line data: E_lower-state minimum per lower level and
    E_lower + nu0 per upper level (vibrational band origins)."""
    reg = LevelRegistry()
    if ll.quanta_global_u is None:
        return reg
    # Lower levels: minimum rotational-less energy ~ min over band of
    # (elower - rot term); use min(elower) as the vibrational origin.
    lower_e: Dict[Tuple[int, int, str], float] = {}
    upper_e: Dict[Tuple[int, int, str], float] = {}
    for k in range(len(ll)):
        klo = (int(ll.mol_id[k]), int(ll.iso_id[k]), ll.quanta_global_l[k].strip())
        kup = (int(ll.mol_id[k]), int(ll.iso_id[k]), ll.quanta_global_u[k].strip())
        e_lo = float(ll.elower[k])
        e_up = float(ll.elower[k] + ll.nu0[k])
        lower_e[klo] = min(lower_e.get(klo, np.inf), e_lo)
        upper_e[kup] = min(upper_e.get(kup, np.inf), e_up)
    for (m, i, q), e in sorted(lower_e.items(), key=lambda kv: kv[1]):
        reg.add(m, i, q, e)
    for (m, i, q), e in sorted(upper_e.items(), key=lambda kv: kv[1]):
        if reg.lookup(m, i, q) < 0:
            reg.add(m, i, q, e)
    return reg


class DeviceNLTE(NamedTuple):
    """Device-side non-LTE state: per-level energies and per-layer vib temps."""

    e_level: jnp.ndarray   # [n_levels] vibrational energies [cm-1]
    t_vib: jnp.ndarray     # [n_levels, n_lay] vibrational temperature [K]


def device_nlte(registry: LevelRegistry, t_vib_lay: np.ndarray,
                dtype=jnp.float32) -> DeviceNLTE:
    """t_vib_lay: [n_levels, n_lay] prescribed vibrational temperatures per
    atmospheric LAYER (already interpolated to layer midpoints)."""
    assert t_vib_lay.shape[0] == registry.n_levels
    return DeviceNLTE(
        e_level=jnp.asarray(np.asarray(registry.energies_cm1), dtype=dtype),
        t_vib=jnp.asarray(t_vib_lay, dtype=dtype),
    )


def lte_t_vib(registry: LevelRegistry, T_lay: np.ndarray) -> np.ndarray:
    """LTE default: every level's T_vib equals the kinetic profile."""
    return np.broadcast_to(np.asarray(T_lay)[None, :],
                           (registry.n_levels, len(T_lay))).copy()


def save_t_vib_npz(path: str, z_m: np.ndarray, keys: List[str],
                   t_vib: np.ndarray) -> None:
    """Persist vibrational-temperature profiles (the reference reads
    campaign vib-temp files [SURVEY.md 4.4]; ours are one .npz):

    z_m [NZ] altitudes; keys [n] strings ``"mol:iso:quanta"``;
    t_vib [n, NZ] temperatures [K].
    """
    assert t_vib.shape == (len(keys), len(z_m))
    np.savez_compressed(path, z=np.asarray(z_m, np.float64),
                        keys=np.asarray(keys, dtype="U"),
                        t_vib=np.asarray(t_vib, np.float64))


def t_vib_from_npz(registry: LevelRegistry, path: str, z_mid_m: np.ndarray,
                   T_lay: np.ndarray) -> np.ndarray:
    """Load vib-temp profiles and interpolate onto layer midpoints.

    Levels present in the file (matched by ``"mol:iso:quanta"``) get the
    interpolated profile; every other registry level defaults to the kinetic
    temperature (= LTE population).
    """
    with np.load(path) as zf:
        z_file = np.asarray(zf["z"], np.float64)
        keys = [str(k) for k in zf["keys"]]
        tv_file = np.asarray(zf["t_vib"], np.float64)
    index = {k: i for i, k in enumerate(keys)}
    t = lte_t_vib(registry, T_lay)
    matched = 0
    for i, (m, iso, q) in enumerate(registry.keys):
        row = index.get(f"{m}:{iso}:{q}")
        if row is not None:
            t[i] = np.interp(np.asarray(z_mid_m), z_file, tv_file[row])
            matched += 1
    if matched == 0:
        raise ValueError(
            f"{path}: no key matches any registry level "
            f"(file keys {keys[:4]}..., registry {registry.keys[:4]}...)")
    return t


def demo_pump_t_vib(registry: LevelRegistry, z_mid_m: np.ndarray,
                    T_lay: np.ndarray, boost: float = 0.35,
                    z_onset_m: float = 50e3, z_scale_m: float = 40e3,
                    ) -> np.ndarray:
    """Built-in daytime-pumping demo: levels with an excited asymmetric-
    stretch quantum (nonzero LAST digit of the global quanta — CO2's nu3,
    the 4.3 um solar-pumped ladder) ramp above ``z_onset_m`` to
    ``(1 + boost) * T_kin``.  Mirrors the config-3 acceptance scene."""
    z = np.asarray(z_mid_m)
    t = lte_t_vib(registry, T_lay)
    ramp = 1.0 + boost * np.clip((z - z_onset_m) / z_scale_m, 0.0, 1.0)
    for i, (m, iso, q) in enumerate(registry.keys):
        qs = q.strip()
        if qs and qs[-1].isdigit() and qs[-1] != "0":
            t[i] = np.asarray(T_lay) * ramp
    return t


def weights_for_layer(
    nlte: Optional[DeviceNLTE],
    lines: DeviceLines,
    lay_idx,
    T_kin,
):
    """Per-line (w_abs, w_em) for one layer (SURVEY.md C8).

    lay_idx: static or traced layer index; T_kin: layer kinetic temperature.
    Returns ([L], [L]); all-ones when ``nlte`` is None.
    """
    L = lines.n_lines
    if nlte is None:
        ones = jnp.ones((L,), dtype=lines.nu0.dtype)
        return ones, ones

    tv = nlte.t_vib[:, lay_idx]                          # [n_levels]
    r_lvl = jnp.exp(-C2 * nlte.e_level * (1.0 / tv - 1.0 / T_kin))
    # Safe gather: unmatched (-1) -> index 0 then overwrite with 1.
    iu = lines.level_upper
    il = lines.level_lower
    r_u = jnp.where(iu >= 0, r_lvl[jnp.maximum(iu, 0)], 1.0)
    r_l = jnp.where(il >= 0, r_lvl[jnp.maximum(il, 0)], 1.0)
    E = jnp.exp(-C2 * lines.nu0_abs / T_kin)
    w_abs = (r_l - r_u * E) / (1.0 - E)
    w_em = r_u
    return w_abs, w_em
