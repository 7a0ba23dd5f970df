"""Line-of-sight radiative-transfer integrator (component C13, SURVEY.md).

The reference (fedef17/SpectRobot ``spect_main_module.radtran*`` [SURVEY.md
1.2/4.1]) integrates the RT equation segment-by-segment in Python/Fortran.
Formulation: fully batched tensor ops over (ray, segment, nu) with
a cumulative sum along the segment axis — no sequential host loop, XLA fuses
the whole chain; differentiable end-to-end for the Jacobians (C15).

Discrete emission-only RT along a ray whose segments are ordered from the
OBSERVER outward:

    I(nu) = sum_k S_k(nu) * (t_k(nu) - t_{k+1}(nu)) + I_bg(nu) * t_end(nu),
    t_k = exp(-sum_{j<k} dtau_j)        (transmittance observer -> segment k)

Scattering is out of scope (as in the reference — thermal IR limb/nadir).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def radiance_along_ray(
    dtau: jnp.ndarray,
    source: jnp.ndarray,
    I_background: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Integrate radiance for one or many rays.

    Args:
      dtau:   [..., n_seg, P] per-segment optical depth (observer-first order).
      source: [..., n_seg, P] per-segment source function radiance.
      I_background: [..., P] radiance entering the far end (surface Planck for
        nadir, deep space = 0 for limb). Default 0.

    Returns: [..., P] radiance at the observer.
    """
    # Inclusive cumulative depth along the segment axis.
    c = jnp.cumsum(dtau, axis=-2)
    t_after = jnp.exp(-c)
    # Transmittance BEFORE segment k is t_after of segment k-1 (and 1 at
    # the observer) — a shift, not a second big exp.
    t_before = jnp.concatenate(
        [jnp.ones_like(t_after[..., :1, :]), t_after[..., :-1, :]], axis=-2)
    emitted = jnp.sum(source * (t_before - t_after), axis=-2)
    if I_background is not None:
        emitted = emitted + I_background * t_after[..., -1, :]
    return emitted


def layer_path_radiance(
    dtau_layers: jnp.ndarray,
    source_layers: jnp.ndarray,
    seg_layer: jnp.ndarray,
    I_background: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Radiance for per-LAYER optics traversed in ``seg_layer`` order:

        onehot[s, l] = [seg_layer[s] == l]
        c    = cumsum_s dtau_layers[seg_layer[s]]  cumulative depth/segment
        w    = t_before - t_after                  emission weight/segment
        wlay = onehot^T @ w                        weights scattered to layers
        I    = sum_l source_layers[l] * wlay[l] (+ background term)

    Identical math to gather -> :func:`radiance_along_ray` (each layer's
    source multiplies the summed weights of its segments).

    Args:
      dtau_layers:   [..., NL, P] one-crossing optical depth per LAYER.
      source_layers: [..., NL, P] source radiance per LAYER.
      seg_layer: [n_seg] int layer index per traversal segment
        (observer-first).
      I_background: [..., P] radiance entering the far end.
    """
    NL = dtau_layers.shape[-2]
    dt = dtau_layers.dtype
    onehot = jax.nn.one_hot(seg_layer, NL, dtype=dt)          # [n_seg, NL]
    c = jnp.cumsum(jnp.take(dtau_layers, seg_layer, axis=-2), axis=-2)
    t_after = jnp.exp(-c)
    t_before = jnp.concatenate(
        [jnp.ones_like(t_after[..., :1, :]), t_after[..., :-1, :]], axis=-2)
    w_layer = jnp.einsum("sl,...sp->...lp", onehot, t_before - t_after,
                         precision=jax.lax.Precision.HIGHEST)
    emitted = jnp.sum(source_layers * w_layer, axis=-2)
    if I_background is not None:
        emitted = emitted + I_background * t_after[..., -1, :]
    return emitted


def transmittance(dtau: jnp.ndarray) -> jnp.ndarray:
    """Total transmittance along the ray: [..., P]."""
    return jnp.exp(-jnp.sum(dtau, axis=-2))
