"""Instrument line shape / field-of-view convolution (C14, SURVEY.md).

The reference (fedef17/SpectRobot ``SpectralObject`` convolution [SURVEY.md
1.2]) convolves monochromatic spectra with an ILS and resamples to instrument
channels.  Design: precompute (host-side, numpy) a dense
channelisation matrix W [n_chan, P] with rows = area-normalised ILS kernels
centred on each channel; application is then a single matmul

    I_chan [.., n_chan] = I_mono [.., P] @ W.T

one dense contraction (SURVEY.md C14: "matmul against precomputed ILS
matrix").  For typical P ~ 1e4-1e5, n_chan ~ 1e2-1e3 the dense matrix
is small next to the spectra; XLA fuses the contraction with upstream ops.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _gaussian(dx: np.ndarray, fwhm: float) -> np.ndarray:
    s = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    return np.exp(-0.5 * (dx / s) ** 2)


def _triangle(dx: np.ndarray, fwhm: float) -> np.ndarray:
    return np.maximum(1.0 - np.abs(dx) / fwhm, 0.0)


def _sinc(dx: np.ndarray, fwhm: float) -> np.ndarray:
    # Unapodised (boxcar-interferogram) FTS response sin(pi a x)/(pi a x):
    # carries the negative side lobes real unapodised spectra have.  FWHM
    # matching: np.sinc(a x) falls to 1/2 at a|x| ~ 0.6034, so
    # a = 1.2067 / fwhm.
    a = 1.2067 / fwhm
    return np.sinc(a * dx)


def _sinc2(dx: np.ndarray, fwhm: float) -> np.ndarray:
    # FTS-style apodised response; first zero at ~1.0034*fwhm/... use sinc^2
    # with FWHM matching: sinc^2 has FWHM ~ 0.8859 * (1/a) for sinc(a x).
    a = 0.8859 / fwhm
    return np.sinc(a * dx) ** 2


_SHAPES: dict = {"gaussian": _gaussian, "triangle": _triangle,
                 "sinc": _sinc, "sinc2": _sinc2}


def ils_matrix(
    nu_grid: np.ndarray,
    nu_channels: np.ndarray,
    fwhm: float,
    shape: str = "gaussian",
    cutoff_fwhm: float = 6.0,
) -> np.ndarray:
    """Dense channelisation matrix W [n_chan, P] (host-side, float64).

    Each row is the ILS centred on a channel, evaluated on the fine grid,
    truncated at ``cutoff_fwhm`` FWHMs and normalised against the actual
    quadrature weights of the fine grid (trapezoid) so that a flat spectrum
    maps to a flat channel vector even near grid edges.
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu_channels = np.asarray(nu_channels, dtype=np.float64)
    fn: Callable = _SHAPES[shape]
    dx = nu_grid[None, :] - nu_channels[:, None]          # [C, P]
    w = fn(dx, fwhm)
    w = np.where(np.abs(dx) <= cutoff_fwhm * fwhm, w, 0.0)
    # Trapezoid quadrature weights of the fine grid.
    q = np.gradient(nu_grid)
    w = w * q[None, :]
    norm = w.sum(axis=1, keepdims=True)
    return w / np.maximum(norm, 1e-300)


def fov_matrix(
    h_fine: np.ndarray,
    h_centers: np.ndarray,
    fwhm_m: float,
    shape: str = "gaussian",
    cutoff_fwhm: float = 6.0,
) -> np.ndarray:
    """Field-of-view smearing matrix over TANGENT HEIGHT (the FOV half of
    SURVEY.md C14 "ILS/FOV convolution"): rows are area-normalised FOV
    responses on the fine tangent-height ladder; apply as I_obs = V @ I with
    I [n_fine_rays, P].  Mathematically identical machinery to
    :func:`ils_matrix` in the vertical coordinate."""
    return ils_matrix(h_fine, h_centers, fwhm_m, shape=shape,
                      cutoff_fwhm=cutoff_fwhm)


def apply_fov(radiances: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """I_obs [n_obs_rays, P] = V [n_obs, n_fine] @ I [n_fine, P]."""
    return jnp.einsum("or,rp->op", V, radiances,
                      precision=jax.lax.Precision.HIGHEST)


def apply_ils(spectra: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """I_chan = spectra @ W.T — batched over any leading axes (one matmul)."""
    return jnp.einsum("...p,cp->...c", spectra, W,
                      preferred_element_type=spectra.dtype,
                      precision=jax.lax.Precision.HIGHEST)
