"""Wavenumber-domain decomposition with wing HALO EXCHANGE (C22/C25).

BASELINE.json:5: "domain-decomposing the wavenumber grid and line list per
chip, overlapping cross-shard line-wing halo exchange with on-chip opacity
accumulation".  This module is that decomposition in its XLA-collective
form:

* The fine grid is sharded over the ``nu`` mesh axis; every LINE is OWNED by
  the shard containing its center (host-side partition of the sorted list).
* A line within ``cutoff`` of a shard boundary also contributes to the
  neighbouring shard's chunk (its wing crosses the boundary).  Instead of a
  line-axis psum (O(n_shards) traffic, parallel/sharded.py), each shard
  exchanges its line PARAMETERS with its two ring neighbours via
  ``lax.ppermute`` — neighbour-only traffic, independent of ring size —
  and accumulates (own + left + right) lines on its local chunk with the
  usual |dnu| <= cutoff mask.  XLA schedules the permutes asynchronously,
  overlapping them with the local (bulk) accumulation — the ring-attention
  analog of SURVEY.md C25.  The sequence axis IS the wavenumber axis.
* Exactness requires cutoff <= chunk width (a wing reaches at most the
  adjacent shard); asserted host-side.

On GPUs XLA hands the permutes to NCCL (NVLink within a host); the same
code runs on the CPU-emulated mesh in the tests (SURVEY.md 5.4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from spectrobot_tpu.ops.opacity import KernelLines, accumulate_jnp


class ShardedKernelLines(NamedTuple):
    """Stage-2 kernel inputs partitioned by line OWNER shard: every array has
    a leading shard axis [n_shards, Lmax]; slots beyond a shard's real line
    count are zero-amplitude pads."""
    nu_c: jnp.ndarray     # [n_shards, Lmax]
    scale_x: jnp.ndarray  # [n_shards, Lmax]
    y: jnp.ndarray        # [n_shards, Lmax]
    amps: jnp.ndarray     # [n_shards, n_out, Lmax]


def partition_kernel_lines(
    kl: KernelLines, nu0_host: np.ndarray, edges: np.ndarray,
    round_to: int = 128,
    origins: Optional[np.ndarray] = None,
    out_dtype=None,
) -> ShardedKernelLines:
    """Host-side: assign each line to the shard whose [edges[k], edges[k+1])
    interval contains its (unshifted) center; pad shards to a common Lmax.

    nu0_host must be sorted (C1 guarantees it), so shard membership is a
    pair of searchsorted cuts and slices stay contiguous.

    ``origins`` (optional, [n_shards]): PER-SHARD wavenumber origins — each
    shard's line centers are stored relative to ITS origin, computed here in
    float64 BEFORE any ``out_dtype`` cast.  This keeps f32 dnu precision
    independent of the GLOBAL band width (a 2000 cm^-1 grid quantises a
    global-origin offset at ~1e-4 cm^-1 ≈ Doppler widths; a per-shard offset
    stays within the chunk width, quantised at ~1e-6).  Pair with
    :func:`rebase_grid_per_shard` for the grid and pass the same origins to
    :func:`halo_accumulate_fn` so halo lines get origin-delta corrected.
    """
    n_shards = len(edges) - 1
    # Clamp: lines below the first / above the last edge (wings reaching in
    # from outside the grid) belong to the first / last shard.
    cuts = np.concatenate([[0], np.searchsorted(nu0_host, edges[1:-1]),
                           [len(nu0_host)]])
    counts = np.diff(cuts)
    Lmax = max(int(counts.max()), 1)
    # Round up so the per-shard line axis tiles nicely (and matches the
    # Pallas BLOCK_L when used with halo_accumulate_pallas_fn).
    Lmax = ((Lmax + round_to - 1) // round_to) * round_to

    def pack(a, fill, shift=None, dtype=None):
        a = np.asarray(a)
        out = np.full((n_shards, Lmax), fill,
                      dtype=a.dtype if dtype is None else dtype)
        for k in range(n_shards):
            seg = a[cuts[k]:cuts[k + 1]].astype(np.float64)
            if shift is not None:
                seg = seg - shift[k]
            out[k, :len(seg)] = seg
        return out

    dt = out_dtype
    amps = np.asarray(kl.amps)
    n_out = amps.shape[0]
    amps_out = np.zeros((n_shards, n_out, Lmax),
                        dtype=amps.dtype if dt is None else dt)
    for k in range(n_shards):
        seg = amps[:, cuts[k]:cuts[k + 1]]
        amps_out[k, :, :seg.shape[1]] = seg
    return ShardedKernelLines(
        nu_c=jnp.asarray(pack(kl.nu_c, 1e9, shift=origins, dtype=dt)),
        scale_x=jnp.asarray(pack(kl.scale_x, 1e6, dtype=dt)),
        y=jnp.asarray(pack(kl.y, 1e6, dtype=dt)),
        amps=jnp.asarray(amps_out),
    )


def nu_shard_origins(edges: np.ndarray) -> np.ndarray:
    """Per-shard f32 wavenumber origins: the midpoint of each shard's
    interval, rounded to 0.25 cm^-1 (exactly representable) so origin deltas
    between neighbours are exact in f32."""
    mid = 0.5 * (edges[:-1] + edges[1:])
    return np.round(mid * 4.0) / 4.0


def rebase_grid_per_shard(nu_host: np.ndarray, origins: np.ndarray,
                          dtype=np.float32) -> jnp.ndarray:
    """Stage the fine grid with PER-SHARD origins: chunk k holds
    (nu - origins[k]), subtracted in float64 then cast.  The result is only
    meaningful together with line centers from ``partition_kernel_lines(...,
    origins=...)`` — coordinates are shard-local."""
    n_shards = len(origins)
    P_ = len(nu_host)
    assert P_ % n_shards == 0
    chunks = np.asarray(nu_host, np.float64).reshape(n_shards, -1)
    return jnp.asarray((chunks - np.asarray(origins)[:, None]
                        ).reshape(P_).astype(dtype))


def halo_accumulate_fn(
    mesh: Mesh,
    *,
    chunk: int = 256,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    origins: Optional[np.ndarray] = None,
):
    """Build f(nu_grid, skl) -> [n_out, P] over the mesh's ``nu`` axis with
    neighbour halo exchange.  nu_grid sharded P('nu'); skl arrays sharded on
    their leading shard axis (one line partition per nu shard).

    With ``origins`` (per-shard f32 grid origins, SURVEY.md round-1 deferred
    item): nu_grid and skl.nu_c are in SHARD-LOCAL coordinates
    (rebase_grid_per_shard / partition_kernel_lines(origins=...)); halo line
    centers received over ppermute are shifted by the known origin DELTA of
    the sending shard so dnu stays exact — the delta is a per-neighbour
    scalar, exact in f32 by construction (origins rounded to 0.25 cm^-1).
    """
    n_shards = mesh.shape["nu"]
    right = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    if origins is None:
        d_from_left = d_from_right = np.zeros((n_shards,))
    else:
        o = np.asarray(origins, np.float64)
        # shard k's grid is relative to o[k]; a line arriving FROM shard s
        # (relative to o[s]) needs + (o[s] - o[k]).
        d_from_left = o[np.arange(-1, n_shards - 1)] - o
        d_from_right = o[(np.arange(n_shards) + 1) % n_shards] - o

    def body(nu_loc, nu_c, sx, y, amps, dl, dr):
        # Leading shard axis is size 1 locally.
        mine = KernelLines(nu_c[0], sx[0], y[0], amps[0])

        def acc(kl):
            return accumulate_jnp(nu_loc, kl, chunk=chunk, variant=variant,
                                  cutoff_cm1=cutoff_cm1)

        out = acc(mine)
        if n_shards > 1:
            # Wing halos: my neighbours' lines can reach my chunk.  ppermute
            # moves each shard's line block one step around the ring; XLA
            # overlaps the permutes with the local accumulation above.
            # With exactly two shards, left and right neighbours coincide —
            # exchange once or the halo double-counts.
            hops = ((right, dl),) if n_shards == 2 else ((right, dl),
                                                         (left, dr))
            for perm, delta in hops:
                got = tuple(
                    lax.ppermute(a, "nu", perm)
                    for a in (nu_c[0], sx[0], y[0], amps[0]))
                nc = got[0] + delta[0].astype(got[0].dtype)
                out = out + acc(KernelLines(nc, *got[1:]))
        return out

    specs_lines = ShardedKernelLines(P("nu"), P("nu"), P("nu"), P("nu"))
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("nu"), specs_lines.nu_c, specs_lines.scale_x,
                  specs_lines.y, specs_lines.amps, P("nu"), P("nu")),
        out_specs=P(None, "nu"), check_vma=False)
    jitted = jax.jit(fn)
    dl_j = jnp.asarray(d_from_left)
    dr_j = jnp.asarray(d_from_right)

    def apply(nu_grid, skl: ShardedKernelLines):
        return jitted(nu_grid, skl.nu_c, skl.scale_x, skl.y, skl.amps,
                      dl_j.astype(nu_grid.dtype), dr_j.astype(nu_grid.dtype))

    return apply


def halo_accumulate_pallas_fn(
    mesh: Mesh,
    nu_host: np.ndarray,
    skl_nu0: np.ndarray,
    *,
    tile_p: Optional[int] = None,
    block_l: Optional[int] = None,
    cutoff_cm1: Optional[float] = 25.0,
    interpret: bool = False,
):
    """Halo-exchange accumulation with the PALLAS kernel per shard — the
    production multi-chip compute path (Pallas inside shard_map).

    nu_host: [P] full fine grid (host, sorted); skl_nu0: [n_shards, Lmax]
    per-shard padded line centers (host — from partition_kernel_lines'
    layout, pads at +1e9).  Per-(shard, source) ragged block windows are
    precomputed HOST-side: each shard needs windows against its own lines
    and against each ring neighbour's line block (which arrives via
    ppermute); the window tables ship as sharded arrays.

    Returns f(nu_grid, skl) -> [n_out, P] (out sharded over 'nu').
    """
    from spectrobot_tpu.ops.pallas_opacity import (
        DEFAULT_BLOCK_L, DEFAULT_TILE_P, _block_windows, _round_up,
        accumulate_pallas_batch_jit)

    tile_p = DEFAULT_TILE_P if tile_p is None else tile_p
    block_l = DEFAULT_BLOCK_L if block_l is None else block_l

    n_shards = mesh.shape["nu"]
    P_ = len(nu_host)
    assert P_ % n_shards == 0
    P_loc = P_ // n_shards
    Pp_loc = _round_up(P_loc, tile_p)
    assert Pp_loc == P_loc, (
        f"local grid chunk {P_loc} must be a multiple of tile_p={tile_p}")
    Lmax = skl_nu0.shape[1]
    assert Lmax % block_l == 0

    # Window tables per (shard, source in {own, from_left, from_right}).
    win_cut = None if cutoff_cm1 is None else cutoff_cm1 + 1.0
    n_tiles_loc = P_loc // tile_p
    starts = np.zeros((n_shards, 3, n_tiles_loc), np.int32)
    counts = np.zeros((n_shards, 3, n_tiles_loc), np.int32)
    max_blocks = 1
    for k in range(n_shards):
        grid_k = np.asarray(nu_host[k * P_loc:(k + 1) * P_loc], np.float32)
        for s_i, src in enumerate((k, (k - 1) % n_shards, (k + 1) % n_shards)):
            st, ct = _block_windows(grid_k, np.asarray(skl_nu0[src], np.float32),
                                    tile_p, block_l, win_cut)
            starts[k, s_i] = st
            counts[k, s_i] = ct
            max_blocks = max(max_blocks, int(ct.max()) if ct.size else 1)

    right = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def body(nu_loc, nu_c, sx, y, amps, st_loc, ct_loc):
        def acc(src_idx, arrs):
            nc, s, yy, am = arrs
            return accumulate_pallas_batch_jit(
                nu_loc, nc[None], s[None], yy[None], am[None],
                windows=(st_loc[0, src_idx], ct_loc[0, src_idx], max_blocks),
                tile_p=tile_p, block_l=block_l, cutoff_cm1=cutoff_cm1,
                interpret=interpret)[0]

        mine = (nu_c[0], sx[0], y[0], amps[0])
        out = acc(0, mine)
        if n_shards > 1:
            got_left = tuple(lax.ppermute(a, "nu", right) for a in mine)
            out = out + acc(1, got_left)
            if n_shards > 2:
                got_right = tuple(lax.ppermute(a, "nu", left) for a in mine)
                out = out + acc(2, got_right)
        return out

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("nu"), P("nu"), P("nu"), P("nu"), P("nu"),
                  P("nu"), P("nu")),
        out_specs=P(None, "nu"), check_vma=False)
    jitted = jax.jit(fn)
    st_j = jnp.asarray(starts)
    ct_j = jnp.asarray(counts)

    def apply(nu_grid, skl: ShardedKernelLines):
        return jitted(nu_grid, skl.nu_c, skl.scale_x, skl.y, skl.amps,
                      st_j, ct_j)

    return apply


def nu_shard_edges(nu_host: np.ndarray, n_shards: int,
                   cutoff_cm1: Optional[float]) -> np.ndarray:
    """Shard ownership edges (equal grid-point counts) + the exactness check
    cutoff <= chunk width.

    The exactness guard is a ValueError (not an assert) because it is
    reachable straight from a TOML file: ``compute.mesh_halo`` on a grid
    narrower than ``mesh_nu * cutoff`` would let line wings cross BEYOND
    the adjacent shard, which the one-hop ring exchange cannot see
    (round-3 review weak item 6).
    """
    P_ = len(nu_host)
    if P_ % n_shards != 0:
        raise ValueError(
            f"grid.n_points ({P_}) must be divisible by the nu-mesh size "
            f"({n_shards}) — adjust grid.n_points or compute.mesh_nu")
    chunk_pts = P_ // n_shards
    edges = np.empty(n_shards + 1)
    edges[:-1] = nu_host[::chunk_pts]
    edges[-1] = nu_host[-1] + (nu_host[-1] - nu_host[-2])
    if cutoff_cm1 is not None:
        min_width = np.diff(edges).min()
        if cutoff_cm1 > min_width:
            raise ValueError(
                f"compute.mesh_halo exactness: wing cutoff "
                f"(compute.cutoff_cm1 = {cutoff_cm1} cm^-1) exceeds the "
                f"narrowest nu-shard width ({min_width:.3g} cm^-1 = grid "
                f"span / compute.mesh_nu), so line wings would reach beyond "
                f"the adjacent shard and the one-hop halo exchange would "
                f"drop them.  Fix one of: lower compute.cutoff_cm1, lower "
                f"compute.mesh_nu, widen grid.nu_min/nu_max, or disable "
                f"compute.mesh_halo (the psum tier has no width "
                f"requirement).")
    return edges
