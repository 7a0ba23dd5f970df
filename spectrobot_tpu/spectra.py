"""Spectral-object family (SURVEY.md 1.2: the reference's ``SpectralObject``
classes in ``spect_classes`` — grid + intensity / transmittance / optical
depth / absorption & emission coefficient, with arithmetic and
instrument-line-shape convolution).

Design: ONE registered pytree class :class:`Spectrum` holding a
wavenumber grid and a (possibly batched) value array, with the physical
``kind`` carried as STATIC aux data.  Because it is a pytree, a Spectrum
flows through ``jax.jit`` / ``vmap`` / ``grad`` unchanged — arithmetic and
unit conversions trace into the same XLA program as the forward model,
instead of the reference's eager NumPy object graph.

Kinds and units (wavenumber convention: cm^-1 everywhere):

    radiance            W m^-2 sr^-1 (cm^-1)^-1
    transmittance       dimensionless in [0, 1]
    optical_depth       dimensionless
    absorption_coeff    cm^2 molec^-1 (cross section) or m^-1 (volume)
    emission_coeff      same family as radiance x absorption
    generic             anything else (arithmetic results of mixed kinds)

Conversions implement the reference's SpectralObject semantics:
``optical_depth.to_transmittance()`` (exp(-tau)), its inverse, radiance ->
brightness temperature, trapezoid band integration, regridding, and ILS
channelisation through :mod:`spectrobot_tpu.ops.ils` (one matmul).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

KINDS = ("radiance", "transmittance", "optical_depth", "absorption_coeff",
         "emission_coeff", "brightness_temperature", "generic")

# Physical units per kind (wavenumber convention: cm^-1 everywhere).
UNITS = {
    "radiance": "W m^-2 sr^-1 (cm^-1)^-1",
    "transmittance": "1",
    "optical_depth": "1",
    "absorption_coeff": "cm^2 molec^-1",
    "emission_coeff": "W m^-2 sr^-1 (cm^-1)^-1 cm^2 molec^-1",
    "brightness_temperature": "K",
    "generic": "",
}


@jax.tree_util.register_pytree_node_class
class Spectrum:
    """A spectrum (or batch of spectra) on a common wavenumber grid.

    values: [..., P] — leading axes batch rays / layers / channels freely.
    nu: [P] wavenumber grid [cm^-1]; kind: static physical tag (see module
    docstring).  Arithmetic requires matching grids (shape-checked at trace
    time; values are the caller's responsibility under jit).
    """

    __slots__ = ("nu", "values", "kind")

    def __init__(self, nu, values, kind: str = "generic"):
        if kind not in KINDS:
            raise ValueError(f"unknown spectrum kind {kind!r}; one of {KINDS}")
        self.nu = nu
        self.values = values
        self.kind = kind

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.nu, self.values), self.kind

    @classmethod
    def tree_unflatten(cls, kind, children):
        nu, values = children
        obj = object.__new__(cls)
        obj.nu = nu
        obj.values = values
        obj.kind = kind
        return obj

    # -- basics ------------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.nu.shape[-1]

    @property
    def shape(self):
        return jnp.shape(self.values)

    @property
    def dtype(self):
        return jnp.result_type(self.values)

    def with_values(self, values, kind: Optional[str] = None) -> "Spectrum":
        return Spectrum(self.nu, values, self.kind if kind is None else kind)

    def __repr__(self):
        return (f"Spectrum(kind={self.kind!r}, n_points={self.n_points}, "
                f"shape={tuple(jnp.shape(self.values))})")

    def _check_grid(self, other: "Spectrum"):
        if jnp.shape(self.nu) != jnp.shape(other.nu):
            raise ValueError(
                f"spectral grids differ: {jnp.shape(self.nu)} vs "
                f"{jnp.shape(other.nu)} — regrid with interp_to() first")

    @staticmethod
    def _combine_kind(a: "Spectrum", b) -> str:
        if isinstance(b, Spectrum) and b.kind != a.kind:
            return "generic"
        return a.kind

    def _binop(self, other, op, kind: Optional[str] = None) -> "Spectrum":
        if isinstance(other, Spectrum):
            self._check_grid(other)
            out = op(self.values, other.values)
        else:
            out = op(self.values, other)
        return Spectrum(self.nu, out,
                        self._combine_kind(self, other) if kind is None
                        else kind)

    # -- arithmetic (reference: SpectralObject operator overloads) ----------
    def __add__(self, other):
        return self._binop(other, jnp.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, jnp.subtract)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, jnp.multiply)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, jnp.divide)

    def __neg__(self):
        return self.with_values(-self.values)

    def __pow__(self, p):
        return self.with_values(self.values ** p, kind="generic")

    def __getitem__(self, sl) -> "Spectrum":
        """Spectral slice: sp[128:256] narrows the grid and values."""
        return Spectrum(self.nu[sl], self.values[..., sl], self.kind)

    # -- conversions ---------------------------------------------------------
    def to_transmittance(self) -> "Spectrum":
        """exp(-tau): optical depth -> transmittance."""
        if self.kind not in ("optical_depth", "generic"):
            raise ValueError(f"to_transmittance on kind {self.kind!r}")
        return Spectrum(self.nu, jnp.exp(-self.values), "transmittance")

    def to_optical_depth(self) -> "Spectrum":
        """-log(t): transmittance -> optical depth (clipped at tiny t)."""
        if self.kind not in ("transmittance", "generic"):
            raise ValueError(f"to_optical_depth on kind {self.kind!r}")
        tiny = jnp.asarray(1e-300 if self.dtype == jnp.float64 else 1e-38,
                           self.dtype)
        return Spectrum(self.nu, -jnp.log(jnp.maximum(self.values, tiny)),
                        "optical_depth")

    def brightness_temperature(self) -> "Spectrum":
        """Inverse Planck per spectral point (radiance -> T_B [K])."""
        from spectrobot_tpu.ops.planck import brightness_temperature
        if self.kind not in ("radiance", "generic"):
            raise ValueError(f"brightness_temperature on kind {self.kind!r}")
        tb = brightness_temperature(self.nu.astype(self.dtype), self.values)
        return Spectrum(self.nu, tb, "brightness_temperature")

    # -- calculus ------------------------------------------------------------
    def integrate(self) -> jnp.ndarray:
        """Trapezoid band integral over the grid (e.g. band radiance
        [W m^-2 sr^-1] from spectral radiance)."""
        return jnp.trapezoid(self.values, self.nu.astype(self.dtype),
                             axis=-1)

    def mean(self) -> jnp.ndarray:
        return jnp.mean(self.values, axis=-1)

    def interp_to(self, nu_new) -> "Spectrum":
        """Linear regrid onto ``nu_new`` (flat-extended at the edges)."""
        flat = self.values.reshape((-1, self.n_points))
        out = jax.vmap(lambda v: jnp.interp(nu_new, self.nu, v))(flat)
        out = out.reshape(self.values.shape[:-1] + (jnp.shape(nu_new)[-1],))
        return Spectrum(nu_new, out, self.kind)

    # -- instrument (C14) ----------------------------------------------------
    def convolve_ils(self, nu_channels, fwhm: float,
                     shape: str = "gaussian",
                     cutoff_fwhm: float = 6.0) -> "Spectrum":
        """ILS channelisation: convolve with the instrument line shape and
        resample to instrument channels (reference SpectralObject
        convolution; ops/ils.py matmul — differentiable).

        Requires a CONCRETE grid (the ILS matrix is built host-side);
        build outside jit or close over the returned matrix.
        """
        from spectrobot_tpu.ops.ils import apply_ils, ils_matrix
        W = jnp.asarray(ils_matrix(np.asarray(self.nu),
                                   np.asarray(nu_channels), fwhm,
                                   shape=shape, cutoff_fwhm=cutoff_fwhm),
                        self.dtype)
        return Spectrum(jnp.asarray(nu_channels), apply_ils(self.values, W),
                        self.kind)

    # -- units ---------------------------------------------------------------
    @property
    def units(self) -> str:
        return UNITS[self.kind]

    # -- persistence (reference: pickle; ours: npz) ---------------------------
    def save_npz(self, path: str, **extra) -> None:
        """Write the Spectrum + axes/units metadata (and any ``extra``
        arrays, e.g. tangent_heights_km) as npz — the CLI's forward output
        format (``python -m spectrobot_tpu forward``)."""
        np.savez(path, nu=np.asarray(self.nu),
                 values=np.asarray(self.values), kind=self.kind,
                 units=self.units,
                 **{k: np.asarray(v) for k, v in extra.items()})

    @staticmethod
    def load_npz(path: str) -> "Spectrum":
        """Load a Spectrum saved by :meth:`save_npz` (extra arrays are
        ignored here; read them with ``np.load`` directly)."""
        d = np.load(path, allow_pickle=False)
        return Spectrum(jnp.asarray(d["nu"]), jnp.asarray(d["values"]),
                        str(d["kind"]))


# convenience constructors ---------------------------------------------------

def radiance(nu, values) -> Spectrum:
    return Spectrum(nu, values, "radiance")


def optical_depth(nu, values) -> Spectrum:
    return Spectrum(nu, values, "optical_depth")


def transmittance(nu, values) -> Spectrum:
    return Spectrum(nu, values, "transmittance")


def absorption_coeff(nu, values) -> Spectrum:
    return Spectrum(nu, values, "absorption_coeff")


def emission_coeff(nu, values) -> Spectrum:
    return Spectrum(nu, values, "emission_coeff")
