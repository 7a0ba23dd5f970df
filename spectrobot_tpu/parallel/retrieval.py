"""Distributed Jacobian assembly for the LM solve (component C26, SURVEY.md).

The measurement vector y (and therefore every Jacobian ROW) is sharded over
the (ray, nu) mesh axes.  The LM normal equations need global

    H = K^T Se^-1 K   [n_x, n_x],     b = K^T Se^-1 r   [n_x]

Two assembly strategies, both collectives:

* :func:`sharded_normal_equations` — each shard contracts its local rows
  (K_s^T Se_s^-1 K_s, K_s^T Se_s^-1 r_s) and ONE psum over the mesh axes
  reduces them: traffic O(n_x^2) per shard, independent of n_y.  This is
  the production path (cheaper than moving K).
* :func:`allgather_jacobian` — materialise the full K on every shard with
  ``lax.all_gather`` (BASELINE.json:5 "assembling analytic Jacobians ... via
  allgather"): needed when the full matrix itself is the product
  (averaging kernels, posterior covariance diagnostics).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def sharded_normal_equations(mesh: Mesh, axes: Tuple[str, ...] = ("ray", "nu")):
    """Build f(K_local_rows, r_local, inv_se_local) -> (H, b) replicated.

    Inputs sharded on their row axis across ``axes``; output replicated.
    K: [n_y, n_x] with rows split over the mesh; r, inv_se: [n_y].
    """

    def body(K, r, inv_se):
        KtSe = K.T * inv_se[None, :]
        # HIGHEST: the normal equations carry condition numbers ~1e6+; the
        # reduced default matmul precision (TF32 on a GPU) would corrupt them
        # (see ops/opacity.py round-1 hardening notes).
        hp = dict(precision=jax.lax.Precision.HIGHEST)
        H_loc = jnp.matmul(KtSe, K, **hp)
        b_loc = jnp.matmul(KtSe, r, **hp)
        H = lax.psum(H_loc, axes)
        b = lax.psum(b_loc, axes)
        return H, b

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axes), P(axes), P(axes)),
        out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)


def allgather_jacobian(mesh: Mesh, axes: Tuple[str, ...] = ("ray", "nu")):
    """Build f(K_local_rows) -> full K replicated on every shard via
    all_gather (C26's literal form)."""

    def body(K):
        # Gather the minor (innermost) axis first so the row order of the
        # reconstructed matrix matches the P(("ray","nu")) sharding layout
        # (major axis outermost in the concatenation).
        for ax in reversed(axes):
            K = lax.all_gather(K, ax, axis=0, tiled=True)
        return K

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(axes),),
                       out_specs=P(), check_vma=False)
    return jax.jit(fn)
