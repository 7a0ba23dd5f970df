"""Atmosphere model and planets (component C10, SURVEY.md section 3).

The reference (fedef17/SpectRobot ``spect_base_module.py`` [SURVEY.md 1.2])
carries an atmospheric-profile class with interpolation plus Mars/Titan planet
constants.  Design: :class:`Atmosphere` is a JAX pytree of flat
arrays on a fixed altitude grid — static shapes, log-pressure interpolation as
pure jnp, differentiable end-to-end (temperature and VMR profiles are inputs
the retrieval differentiates through, SURVEY.md C15/C16).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.constants import K_BOLTZ, AMU


@dataclasses.dataclass(frozen=True)
class Planet:
    name: str
    radius_m: float        # mean radius [m]
    g0: float              # surface gravity [m/s^2]
    mu_amu: float          # mean molecular mass [amu]


MARS = Planet("Mars", 3389.5e3, 3.711, 43.34)
TITAN = Planet("Titan", 2574.7e3, 1.352, 28.0)
EARTH = Planet("Earth", 6371.0e3, 9.80665, 28.9647)
PLANETS: Dict[str, Planet] = {p.name.lower(): p for p in (MARS, TITAN, EARTH)}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Atmosphere:
    """1-D atmosphere on a fixed altitude grid (level quantities).

    Fields (all [n_lev], SI units):
      z       altitude above surface [m]
      p       pressure [Pa]
      T       temperature [K]
      n       total number density [m^-3]
      vmr     volume mixing ratios, dict name -> [n_lev]
    """

    z: jnp.ndarray
    p: jnp.ndarray
    T: jnp.ndarray
    n: jnp.ndarray
    vmr: Dict[str, jnp.ndarray]

    @property
    def n_lev(self) -> int:
        return int(self.z.shape[0])

    def with_temperature(self, T_new: jnp.ndarray) -> "Atmosphere":
        """Replace T and rehydrate density at fixed pressure (ideal gas).

        Used by the retrieval when perturbing the temperature profile: p(z) is
        held fixed (hydrostatic re-adjustment is second order for limb
        weighting and is what single-profile retrievals conventionally do).

        Computed as (p/T)/k_B, NOT p/(k_B*T): the division JVP squares the
        denominator, and (k_B*T)^2 ~ 1e-41 underflows float32 — T carries the
        retrieval tangents, so the tangent-bearing denominator must stay in
        normal range.
        """
        n_new = (self.p / T_new) * (1.0 / K_BOLTZ)
        return dataclasses.replace(self, T=T_new, n=n_new)

    def with_vmr(self, name: str, vmr_new: jnp.ndarray) -> "Atmosphere":
        vmr = dict(self.vmr)
        vmr[name] = vmr_new
        return dataclasses.replace(self, vmr=vmr)

    # -- interpolation (log-p in altitude) ----------------------------------

    def interp_T(self, z_q: jnp.ndarray) -> jnp.ndarray:
        return jnp.interp(z_q, self.z, self.T)

    def interp_logp(self, z_q: jnp.ndarray) -> jnp.ndarray:
        return jnp.exp(jnp.interp(z_q, self.z, jnp.log(self.p)))

    def interp_n(self, z_q: jnp.ndarray) -> jnp.ndarray:
        return jnp.exp(jnp.interp(z_q, self.z, jnp.log(self.n)))

    def interp_vmr(self, name: str, z_q: jnp.ndarray) -> jnp.ndarray:
        return jnp.interp(z_q, self.z, self.vmr[name])

    # -- persistence (matches the CLI scene loader's .npz layout) -----------

    def save_npz(self, path: str) -> None:
        arrays = {"z": np.asarray(self.z), "p": np.asarray(self.p),
                  "T": np.asarray(self.T), "n": np.asarray(self.n)}
        for k, v in self.vmr.items():
            arrays[f"vmr_{k}"] = np.asarray(v)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load_npz(path: str) -> "Atmosphere":
        with np.load(path) as z:
            return Atmosphere(
                z=jnp.asarray(z["z"]), p=jnp.asarray(z["p"]),
                T=jnp.asarray(z["T"]), n=jnp.asarray(z["n"]),
                vmr={k[4:]: jnp.asarray(z[k]) for k in z.files
                     if k.startswith("vmr_")})


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Atmosphere2D:
    """Latitude x altitude atmosphere (level quantities).

    The reference's profile class carries lat/alt grids and interpolates to
    the observation latitude (``spect_base_module`` [SURVEY.md 1.2]).
    Design: dense [NLAT, NZ] arrays on a shared altitude grid;
    :meth:`at_lat` is a differentiable linear interpolation in latitude
    (log-space for p and n) returning a standard 1-D :class:`Atmosphere`,
    so one 2-D climatology serves a whole limb-scan campaign and latitude
    can even be a traced quantity inside jit.
    """

    lat_deg: jnp.ndarray            # [NLAT] ascending
    z: jnp.ndarray                  # [NZ]
    p: jnp.ndarray                  # [NLAT, NZ]
    T: jnp.ndarray                  # [NLAT, NZ]
    n: jnp.ndarray                  # [NLAT, NZ]
    vmr: Dict[str, jnp.ndarray]     # name -> [NLAT, NZ]

    @property
    def n_lat(self) -> int:
        return int(self.lat_deg.shape[0])

    def at_lat(self, lat_q) -> Atmosphere:
        """1-D atmosphere at latitude ``lat_q`` [deg] (clamped to the grid).
        Linear in T/VMR, log-linear in p/n; differentiable in lat_q."""
        nlat = self.lat_deg.shape[0]
        idx = jnp.clip(jnp.searchsorted(self.lat_deg, lat_q) - 1, 0, nlat - 2)
        lo = self.lat_deg[idx]
        hi = self.lat_deg[idx + 1]
        w = jnp.clip((lat_q - lo) / (hi - lo), 0.0, 1.0)

        def mix(a):
            return (1.0 - w) * a[idx] + w * a[idx + 1]

        def mix_log(a):
            return jnp.exp((1.0 - w) * jnp.log(a[idx]) + w * jnp.log(a[idx + 1]))

        return Atmosphere(z=self.z, p=mix_log(self.p), T=mix(self.T),
                          n=mix_log(self.n),
                          vmr={k: mix(v) for k, v in self.vmr.items()})

    @staticmethod
    def from_profiles(lats_deg, atms) -> "Atmosphere2D":
        """Stack 1-D atmospheres (shared z grid) into a 2-D climatology."""
        z0 = np.asarray(atms[0].z)
        for a in atms[1:]:
            assert np.array_equal(np.asarray(a.z), z0), "z grids must match"
        names = sorted(atms[0].vmr)
        return Atmosphere2D(
            lat_deg=jnp.asarray(np.asarray(lats_deg, np.float64)),
            z=atms[0].z,
            p=jnp.stack([a.p for a in atms]),
            T=jnp.stack([a.T for a in atms]),
            n=jnp.stack([a.n for a in atms]),
            vmr={k: jnp.stack([a.vmr[k] for a in atms]) for k in names})

    def save_npz(self, path: str) -> None:
        arrays = {"lat_deg": np.asarray(self.lat_deg), "z": np.asarray(self.z),
                  "p": np.asarray(self.p), "T": np.asarray(self.T),
                  "n": np.asarray(self.n)}
        for k, v in self.vmr.items():
            arrays[f"vmr_{k}"] = np.asarray(v)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load_npz(path: str) -> "Atmosphere2D":
        with np.load(path) as z:
            return Atmosphere2D(
                lat_deg=jnp.asarray(z["lat_deg"]), z=jnp.asarray(z["z"]),
                p=jnp.asarray(z["p"]), T=jnp.asarray(z["T"]),
                n=jnp.asarray(z["n"]),
                vmr={k[4:]: jnp.asarray(z[k]) for k in z.files
                     if k.startswith("vmr_")})


def hydrostatic_atmosphere(
    planet: Planet,
    z: np.ndarray,
    T_of_z,
    p_surface: float,
    vmr: Dict[str, np.ndarray],
) -> Atmosphere:
    """Build an atmosphere in hydrostatic equilibrium (host-side, numpy).

    dp/dz = -p * mu g(z) / (k T(z)); integrated with midpoint stepping on the
    given grid.  ``T_of_z`` is a callable T(z) or an array on ``z``.
    """
    z = np.asarray(z, dtype=np.float64)
    T = np.asarray(T_of_z(z) if callable(T_of_z) else T_of_z, dtype=np.float64)
    mu = planet.mu_amu * AMU
    p = np.empty_like(z)
    p[0] = p_surface
    for i in range(1, z.shape[0]):
        dz = z[i] - z[i - 1]
        zm = 0.5 * (z[i] + z[i - 1])
        g = planet.g0 * (planet.radius_m / (planet.radius_m + zm)) ** 2
        Tm = 0.5 * (T[i] + T[i - 1])
        H = K_BOLTZ * Tm / (mu * g)
        p[i] = p[i - 1] * np.exp(-dz / H)
    n = p / (K_BOLTZ * T)
    return Atmosphere(
        z=jnp.asarray(z), p=jnp.asarray(p), T=jnp.asarray(T), n=jnp.asarray(n),
        vmr={k: jnp.asarray(np.broadcast_to(np.asarray(v, dtype=np.float64), z.shape).copy())
             for k, v in vmr.items()},
    )


def titan_standard_atmosphere(n_lev: int = 51, z_top: float = 600e3) -> Atmosphere:
    """A smooth Titan-like reference atmosphere (N2-dominated with CH4/CO) —
    the reference's second target body (SURVEY.md 1.1 'Mars/Titan focus')."""
    z = np.linspace(0.0, z_top, n_lev)

    def T_of_z(zz):
        # ~94 K surface, tropopause minimum ~70 K near 40 km, rising to
        # ~170 K in the upper atmosphere — the canonical Titan shape.
        return (94.0 - 24.0 * np.clip(zz / 40e3, 0.0, 1.0)
                + 100.0 * np.clip((zz - 40e3) / 360e3, 0.0, 1.0))

    vmr = {
        "N2": np.full(n_lev, 0.943),
        "CH4": 0.014 + 0.034 * np.exp(-z / 30e3),   # enriched near surface
        "CO": np.full(n_lev, 4.7e-5),
        "C2H2": 3.0e-6 * np.clip(z / 200e3, 0.0, 1.0) + 1e-9,
    }
    return hydrostatic_atmosphere(TITAN, z, T_of_z, p_surface=1.467e5,
                                  vmr=vmr)


def mars_standard_atmosphere(n_lev: int = 51, z_top: float = 100e3) -> Atmosphere:
    """A smooth Mars-like reference atmosphere (CO2-dominated) used by the
    acceptance configs (BASELINE.json configs 2/3/5) and tests."""
    z = np.linspace(0.0, z_top, n_lev)

    def T_of_z(zz):
        # Smooth profile: ~210 K surface, decreasing to ~140 K aloft with a
        # mild mesospheric bump — representative of Mars daytime.
        return 145.0 + 65.0 * np.exp(-zz / 35e3) + 8.0 * np.exp(-((zz - 70e3) / 12e3) ** 2)

    vmr = {
        "CO2": np.full(n_lev, 0.9532),
        "CO": np.full(n_lev, 7.0e-4),
        "H2O": 2.0e-4 * np.exp(-z / 20e3),
        "N2": np.full(n_lev, 0.027),
    }
    return hydrostatic_atmosphere(MARS, z, T_of_z, p_surface=610.0, vmr=vmr)


def mars_zonal_atmosphere(n_lat: int = 7, n_lev: int = 51,
                          z_top: float = 100e3) -> Atmosphere2D:
    """A smooth zonal-mean Mars climatology: equator-to-pole cooling (~30 K
    at the surface), drier and lower-pressure high latitudes — a physically
    shaped 2-D fixture for latitude-resolved limb campaigns."""
    lats = np.linspace(-90.0, 90.0, n_lat)
    z = np.linspace(0.0, z_top, n_lev)
    atms = []
    for lat in lats:
        cosl = np.cos(np.radians(lat))
        dT = 30.0 * (cosl - 1.0)            # 0 at equator, -30 K at poles

        def T_of_z(zz, dT=dT):
            return (145.0 + dT * np.exp(-zz / 25e3)
                    + 65.0 * np.exp(-zz / 35e3)
                    + 8.0 * np.exp(-((zz - 70e3) / 12e3) ** 2))

        vmr = {
            "CO2": np.full(n_lev, 0.9532),
            "CO": np.full(n_lev, 7.0e-4),
            "H2O": (0.3 + 0.7 * cosl) * 2.0e-4 * np.exp(-z / 20e3),
            "N2": np.full(n_lev, 0.027),
        }
        atms.append(hydrostatic_atmosphere(
            MARS, z, T_of_z, p_surface=610.0 * (0.85 + 0.15 * cosl), vmr=vmr))
    return Atmosphere2D.from_profiles(lats, atms)
