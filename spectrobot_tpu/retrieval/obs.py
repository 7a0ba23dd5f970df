"""Observation / pixel model (component C17, SURVEY.md).

The reference (fedef17/SpectRobot ``spect_main_module`` obs/pixel classes
[SURVEY.md 1.2]) carries observed spectra, noise and geometry per pixel with
spectral masks/windows.  Design: one :class:`Observation` of
dense [n_ray, n_chan] arrays; masking is encoded as INFINITE noise (weight
zero) so shapes stay static under jit — excluded channels simply do not
contribute to chi^2 or the normal equations, and the degrees-of-freedom
bookkeeping uses the mask count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

_BIG_SIGMA = 1.0e30


@dataclasses.dataclass
class Observation:
    """A limb-scan (or nadir) observation set.

    y:       [n_ray, n_chan] measured radiances [W m-2 sr-1 (cm-1)-1]
    sigma:   [n_ray, n_chan] per-channel noise std
    mask:    [n_ray, n_chan] bool, True = channel used
    nu_channels: [n_chan] channel centers [cm-1]
    tangent_heights_m: [n_ray] (limb) or None
    sec_theta: [n_ray] (nadir) or None
    """

    y: np.ndarray
    sigma: np.ndarray
    mask: np.ndarray
    nu_channels: np.ndarray
    tangent_heights_m: Optional[np.ndarray] = None
    sec_theta: Optional[np.ndarray] = None

    @property
    def n_ray(self) -> int:
        return int(self.y.shape[0])

    @property
    def n_chan(self) -> int:
        return int(self.y.shape[1])

    @property
    def n_used(self) -> int:
        return int(self.mask.sum())

    def with_windows(self, windows: Sequence[Tuple[float, float]]) -> "Observation":
        """Restrict to spectral windows: channels outside every (lo, hi)
        interval are masked out (SURVEY.md C17 'masks/windows')."""
        inside = np.zeros(self.n_chan, dtype=bool)
        for lo, hi in windows:
            inside |= (self.nu_channels >= lo) & (self.nu_channels <= hi)
        return dataclasses.replace(
            self, mask=self.mask & inside[None, :])

    def flattened(self) -> Tuple[np.ndarray, np.ndarray]:
        """(y_flat, sigma_flat) for the OE loop; masked channels get
        sigma = 1e30 (zero weight, static shape)."""
        sig = np.where(self.mask, self.sigma, _BIG_SIGMA)
        return self.y.reshape(-1), sig.reshape(-1)

    def chi2_per_dof(self, chi2_meas: float) -> float:
        return chi2_meas / max(self.n_used, 1)

    # -- persistence --------------------------------------------------------

    def save_npz(self, path: str) -> None:
        arrays = dict(y=self.y, sigma=self.sigma, mask=self.mask,
                      nu_channels=self.nu_channels)
        if self.tangent_heights_m is not None:
            arrays["tangent_heights_m"] = self.tangent_heights_m
        if self.sec_theta is not None:
            arrays["sec_theta"] = self.sec_theta
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load_npz(path: str) -> "Observation":
        with np.load(path) as z:
            return Observation(
                y=z["y"], sigma=z["sigma"], mask=z["mask"].astype(bool),
                nu_channels=z["nu_channels"],
                tangent_heights_m=z.get("tangent_heights_m"),
                sec_theta=z.get("sec_theta"))

    @staticmethod
    def load(path: str) -> "Observation":
        """Auto-dispatching loader: ``.npz`` (save_npz round-trip) or a
        campaign-style text table (``.csv``/``.txt``/``.dat``/``.tbl`` —
        see :meth:`load_table`)."""
        if path.endswith(".npz"):
            return Observation.load_npz(path)
        return Observation.load_table(path)

    @staticmethod
    def load_table(path: str) -> "Observation":
        """Read a campaign-style TEXT observation table (round-1 review
        item 8 — pointing the framework at real data needs no code).

        Format: one sample per row, comma- or whitespace-separated, in
        "tidy" (long) layout::

            # geometry = limb            (or: nadir)
            # columns: geom nu radiance sigma [mask]
            8.0   660.125  1.23e-2  1.0e-4
            8.0   660.375  1.21e-2  1.0e-4
            25.0  660.125  4.02e-3  1.0e-4

        * column 1 (``geom``): tangent height [km] for limb geometry, or
          sec(zenith angle) for nadir (declared by a ``# geometry =`` header
          comment; default limb);
        * column 2: channel wavenumber [cm-1];
        * columns 3/4: radiance and noise sigma (any consistent radiance
          units — the retrieval is unit-agnostic as long as the forward
          model matches);
        * optional column 5: 0/1 mask (1 = use the channel).

        Rows may arrive in any order; rays are the sorted unique geometry
        values and channels the sorted unique wavenumbers.  (ray, channel)
        combinations absent from the file are masked out — ragged campaign
        coverage maps onto the static-shape mask representation.
        """
        geometry = "limb"
        rows = []
        with open(path) as f:
            for ln in f:
                s = ln.strip()
                if not s:
                    continue
                if s.startswith("#"):
                    key, _, val = s[1:].partition("=")
                    if key.strip().lower() == "geometry":
                        geometry = val.strip().lower()
                    continue
                parts = s.replace(",", " ").split()
                rows.append([float(p) for p in parts])
        if not rows:
            raise ValueError(f"no data rows in observation table {path!r}")
        n_cols = len(rows[0])
        if n_cols not in (4, 5) or any(len(r) != n_cols for r in rows):
            raise ValueError(
                f"observation table {path!r} needs 4 or 5 columns "
                f"(geom nu radiance sigma [mask]); got {n_cols}")
        data = np.asarray(rows, dtype=np.float64)
        geoms = np.unique(data[:, 0])
        chans = np.unique(data[:, 1])
        gi = np.searchsorted(geoms, data[:, 0])
        ci = np.searchsorted(chans, data[:, 1])
        shape = (geoms.size, chans.size)
        y = np.zeros(shape)
        sigma = np.full(shape, _BIG_SIGMA)
        mask = np.zeros(shape, dtype=bool)
        y[gi, ci] = data[:, 2]
        sigma[gi, ci] = data[:, 3]
        mask[gi, ci] = (data[:, 4] > 0.5) if n_cols == 5 else True
        kw = (dict(tangent_heights_m=geoms * 1e3) if geometry == "limb"
              else dict(sec_theta=geoms))
        return Observation(y=y, sigma=sigma, mask=mask, nu_channels=chans,
                           **kw)

    def save_table(self, path: str) -> None:
        """Write the text-table format of :meth:`load_table`."""
        geom = (self.tangent_heights_m / 1e3
                if self.tangent_heights_m is not None else self.sec_theta)
        mode = "limb" if self.tangent_heights_m is not None else "nadir"
        with open(path, "w") as f:
            f.write(f"# geometry = {mode}\n")
            f.write("# columns: geom nu radiance sigma mask\n")
            for i in range(self.n_ray):
                for j in range(self.n_chan):
                    f.write(f"{geom[i]:.6f} {self.nu_channels[j]:.6f} "
                            f"{self.y[i, j]:.8e} {self.sigma[i, j]:.8e} "
                            f"{int(self.mask[i, j])}\n")

    @staticmethod
    def synthesize(y_clean: np.ndarray, nu_channels: np.ndarray,
                   noise_sigma: float, seed: int = 0,
                   tangent_heights_m: Optional[np.ndarray] = None,
                   sec_theta: Optional[np.ndarray] = None) -> "Observation":
        """Simulated observation: clean radiances + white noise."""
        rng = np.random.default_rng(seed)
        y = y_clean + noise_sigma * rng.standard_normal(y_clean.shape)
        return Observation(
            y=y, sigma=np.full_like(y_clean, noise_sigma),
            mask=np.ones(y_clean.shape, dtype=bool),
            nu_channels=np.asarray(nu_channels),
            tangent_heights_m=tangent_heights_m, sec_theta=sec_theta)
