"""Sharded forward model over the (ray, line, nu) mesh (C21-C23, C26).

Decomposition (SURVEY.md section 2.2 L4, BASELINE.json:5 "domain-decomposing
the wavenumber grid and line list per chip"):

* ``nu``   — each chip owns a contiguous chunk of the fine wavenumber grid.
* ``line`` — each chip owns a slice of the (nu0-sorted) line list and
  accumulates PARTIAL (dtau, dtau_em) on its local grid chunk; one
  ``lax.psum`` over the ``line`` axis completes the sums.  The psum happens
  BEFORE the nonlinear source assembly, which keeps line-sharding exact
  (see forward.limb.layer_tau).
* ``ray``  — tangent heights are pure data parallelism.

Communication pattern per forward step — two production tiers
(round-2 review item 1):

* ``nu_halo=False`` (default): every line shard evaluates against its LOCAL
  grid chunk with the |dnu| <= cutoff mask, and exactly one ``psum`` (over
  'line') completes the sums.  Mathematically identical to a halo exchange
  of wing contributions, but the psum moves O(R*NL*P_loc) partial spectra.
* ``nu_halo=True``: lines are OWNED by the nu shard containing their center
  (:func:`partition_lines_by_nu`); each shard accumulates its own lines
  plus its ring neighbours' line PARAMETERS received via ``lax.ppermute`` —
  neighbour-only traffic of O(L_shard) line params instead of partial
  spectra, overlapped by XLA with the local accumulation.  This is the
  BASELINE.json:5 "overlapping cross-shard line-wing halo exchange with
  on-chip opacity accumulation" tier; exactness requires
  cutoff <= shard width (asserted host-side).

Either tier runs the opacity stage with ``engine='jnp'`` (XLA scan) or
``engine='pallas'`` (the C5/C6 GPU kernel, jit-composable inside shard_map;
``interpret=True`` for CPU-emulated meshes) — the kernel and the mesh
compose.

Why ppermute (not device-initiated remote DMA) is THE halo transport: the
body permutes the RAW per-line fields (11 arrays of O(L_shard)) and
re-derives per-(ray, layer) kernel inputs locally, whereas a fused
halo-in-kernel copy must ship precomputed (nu_c, scale_x, y, amps), which
are per-(ray, layer) — ~91x the bytes at config-2 scale — and would give
up the static ragged windows.  XLA emits async collective-permute
start/done pairs (NCCL on GPUs) and can overlap the (tiny) transfers with
the independent own-line prologue.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spectrobot_tpu.data.nlte import DeviceNLTE
from spectrobot_tpu.forward.geometry import PathCG
from spectrobot_tpu.forward.limb import layer_tau, tau_radiance_epilogue
from spectrobot_tpu.ops.strengths import DeviceLines

# PartitionSpecs for the pytrees crossing the shard_map boundary.
LINES_SPECS = DeviceLines(
    nu0=P("line"), sw=P("line"), elower=P("line"), gamma_air=P("line"),
    gamma_self=P("line"), n_air=P("line"), delta_air=P("line"),
    mass_amu=P("line"), species_idx=P("line"), level_upper=P("line"),
    level_lower=P("line"), q_tbl=P(), q_tgrid=P(), nu_ref=P(),
)
NLTE_SPECS = DeviceNLTE(e_level=P(), t_vib=P())

# Per-line DeviceLines fields (leading [L] axis); the trailing three
# (q_tbl, q_tgrid, nu_ref) are replicated lookup state.
PER_LINE_FIELDS = DeviceLines._fields[:11]
# nu-halo layout: per-line fields carry a leading owner-shard axis
# [n_nu, Lmax] — sharded over BOTH mesh axes (owner set over 'nu', the
# within-owner slice over 'line').
HALO_LINES_SPECS = DeviceLines(
    *([P("nu", "line")] * 11), q_tbl=P(), q_tgrid=P(), nu_ref=P(),
)


def sharded_radiance_fn(
    mesh: Mesh,
    has_nlte: bool,
    has_background: bool,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    engine: str = "jnp",
    interpret: bool = False,
    nu_halo: bool = False,
    cia_pairs: Optional[tuple] = None,
    is_limb: bool = True,
    emissivity: float = 1.0,
    win_grid=None,
    win_lines=None,
    chi=None,
):
    """Build the jitted shard_map radiance function for a mesh.

    ``chi`` = (ops.chi.ChiProfile, row_mask tuple) — the sub-Lorentzian
    wing correction (ops/chi.py), fully static, so it flows into every
    layer_tau call inside the body unchanged (owner lines AND halo hops:
    species_idx rides PER_LINE_FIELDS through the ppermute, so permuted
    neighbour lines compute their own chi slopes locally).

    Returns f(nu_grid, lines, cg, nlte, I_bg, cia_tables, cia_tgrid) -> I
    [R, P] with R % mesh['ray'] == 0, P % mesh['nu'] == 0, L % mesh['line']
    == 0.  ``nlte`` / ``I_bg`` must be None iff has_nlte/has_background are
    False.  PathCG's static fields don't cross the shard_map boundary — only
    its arrays do (flat), and the struct is rebuilt locally.

    ``engine='pallas'`` runs the opacity stage on the C5/C6 GPU kernel
    (ops.opacity.accumulate_pallas_jit — jit-composable, so it traces
    cleanly inside the shard_map body; pass ``interpret=True`` on
    CPU-emulated meshes).  ``nu_halo=True`` switches the line distribution
    to owner-shard + ring halo exchange (module docstring); the lines
    pytree must then come from :func:`partition_lines_by_nu`.

    ``cia_pairs`` = (pair_a, pair_b) static index tuples of a staged
    ops.cia.DeviceCIA enables the collision-induced continuum INSIDE the
    mesh forward (round-2 review item 6): the [n_pair, nT, P] tables are
    additive per (ray, layer, nu) and carry no line data, so they shard over
    'nu' and add locally after the line psum.

    ``is_limb=False`` integrates NADIR rays (round-2 review item 8):
    the cg pytree comes from geometry.nadir_path_cg ('ray' shards pixels /
    viewing angles), ``I_bg`` carries eps*B(T_surface), and for
    ``emissivity < 1`` the Lambertian reflected downwelling is added from
    the SAME layer optics integrated surface-first — all local to each
    (ray, nu) chunk, so nadir needs no collective beyond the line psum.

    ``win_grid``/``win_lines`` (engine='pallas'): HOST-side offset-
    coordinate grid [P] and line centers (non-halo: the padded global [Lp]
    sorted centers; halo: partition_lines_by_nu's [n_nu, Lmax] buffer).
    Per-(shard, source) ragged kernel windows are precomputed from them
    and selected inside the body via ``lax.axis_index`` — the sharded
    analog of the static windows layer_tau bakes in single-device
    (bit-identical; blocks provably outside the cutoff are skipped).
    """
    n_nu = mesh.shape["nu"]
    n_line = mesh.shape["line"]
    tau_kw = dict(variant=variant, cutoff_cm1=cutoff_cm1, chunk=chunk,
                  engine=engine, interpret=interpret, chi=chi)

    if nu_halo:
        right = [(i, (i + 1) % n_nu) for i in range(n_nu)]
        left = [(i, (i - 1) % n_nu) for i in range(n_nu)]

    # Per-shard kernel window tables (closed-over constants; the body picks
    # its rows by mesh coordinates).
    WST = WCT = None
    max_blocks = 1
    if (engine == "pallas" and cutoff_cm1 is not None
            and win_grid is not None and win_lines is not None):
        import numpy as np

        from spectrobot_tpu.ops.pallas_opacity import (
            DEFAULT_TILE_P, static_windows)
        g = np.asarray(win_grid, np.float64)
        assert g.shape[0] % n_nu == 0
        g = g.reshape(n_nu, -1)
        arr = np.asarray(win_lines, np.float64)
        if not nu_halo:
            assert arr.ndim == 1 and arr.shape[0] % n_line == 0
            sl = arr.reshape(n_line, -1)
            st_all, ct_all = [], []
            for k in range(n_nu):
                st_k, ct_k = [], []
                for li in range(n_line):
                    s, c, m = static_windows(g[k], sl[li],
                                             cutoff_cm1=cutoff_cm1)
                    st_k.append(s)
                    ct_k.append(c)
                    max_blocks = max(max_blocks, m)
                st_all.append(st_k)
                ct_all.append(ct_k)
            WST = jnp.asarray(np.asarray(st_all))   # [n_nu, n_line, n_t]
            WCT = jnp.asarray(np.asarray(ct_all))
        else:
            assert arr.ndim == 2 and arr.shape[0] == n_nu
            Lloc = arr.shape[1] // n_line
            n_t = -(-g.shape[1] // DEFAULT_TILE_P)  # tiles per chunk
            WSTn = np.zeros((n_nu, 3, n_line, n_t), np.int32)
            WCTn = np.zeros_like(WSTn)
            for k in range(n_nu):
                for s_i, src in enumerate((k, (k - 1) % n_nu,
                                           (k + 1) % n_nu)):
                    for li in range(n_line):
                        s, c, m = static_windows(
                            g[k], arr[src, li * Lloc:(li + 1) * Lloc],
                            cutoff_cm1=cutoff_cm1)
                        WSTn[k, s_i, li] = s
                        WCTn[k, s_i, li] = c
                        max_blocks = max(max_blocks, m)
            WST, WCT = jnp.asarray(WSTn), jnp.asarray(WCTn)

    def body(nu_loc, nu_off_loc, lines_loc, u, T_sp, p_sp, ps_sp, T_air,
             u_air, uu_air, seg_layer, nlte_loc, bg_loc, cia_tab_loc,
             cia_tg_loc):
        cg_loc = PathCG(u=u, T_sp=T_sp, p_sp=p_sp, p_self_sp=ps_sp,
                        T_air=T_air, seg_layer=seg_layer,
                        seg_count=int(seg_layer.shape[0]), is_limb=is_limb,
                        u_air=u_air, uu_air=uu_air)
        if WST is not None:
            idx_nu = lax.axis_index("nu")
            idx_line = lax.axis_index("line")
            win = lambda *ix: (WST[ix], WCT[ix], max_blocks)
        if not nu_halo:
            dtau, dtau_em = layer_tau(
                nu_loc, lines_loc, cg_loc, nlte_loc, nu_off=nu_off_loc,
                windows=None if WST is None else win(idx_nu, idx_line),
                **tau_kw)
        else:
            # Owner lines arrive with leading shard axis of local size 1.
            mine = tuple(getattr(lines_loc, f)[0] for f in PER_LINE_FIELDS)
            shared = (lines_loc.q_tbl, lines_loc.q_tgrid, lines_loc.nu_ref)
            dtau, dtau_em = layer_tau(
                nu_loc, DeviceLines(*mine, *shared), cg_loc, nlte_loc,
                nu_off=nu_off_loc,
                windows=None if WST is None else win(idx_nu, 0, idx_line),
                **tau_kw)
            if n_nu > 1:
                # Wing halos: neighbour-owned lines within ``cutoff`` of my
                # boundary contribute to my chunk.  ppermute moves each
                # shard's line PARAMETERS one hop around the ring; XLA
                # overlaps the permutes with the local accumulation above.
                # With exactly two shards left == right: exchange once or
                # the halo double-counts.  Coordinates are global-origin
                # offsets (DeviceLines.nu_ref is shared), so permuted
                # centers need no correction; far (wrap-around) lines are
                # killed by the |dnu| <= cutoff mask.
                hops = ((right, 1),) if n_nu == 2 else ((right, 1),
                                                       (left, 2))
                for perm, s_i in hops:
                    got = tuple(lax.ppermute(a, "nu", perm) for a in mine)
                    d2, d2e = layer_tau(
                        nu_loc, DeviceLines(*got, *shared), cg_loc,
                        nlte_loc, nu_off=nu_off_loc,
                        windows=(None if WST is None
                                 else win(idx_nu, s_i, idx_line)),
                        **tau_kw)
                    dtau, dtau_em = dtau + d2, dtau_em + d2e
        # C23: complete the line sums across the line axis (single psum).
        dtau, dtau_em = lax.psum((dtau, dtau_em), "line")
        cia_loc = None
        if cia_pairs is not None:
            from spectrobot_tpu.ops.cia import DeviceCIA
            cia_loc = DeviceCIA(tables=cia_tab_loc, T_grid=cia_tg_loc,
                                pair_a=cia_pairs[0], pair_b=cia_pairs[1])
        # CIA add + source assembly + grey-surface reflection are all
        # pointwise in (ray, nu) — the shared local epilogue applies per
        # chunk unchanged.
        return tau_radiance_epilogue(nu_loc, cg_loc, dtau, dtau_em,
                                     cia=cia_loc, I_background=bg_loc,
                                     is_limb=is_limb, emissivity=emissivity)

    in_specs = (
        P("nu"), P("nu"),
        HALO_LINES_SPECS if nu_halo else LINES_SPECS,
        P("ray"), P("ray"), P("ray"), P("ray"), P("ray"), P("ray"),
        P("ray"), P(),
        NLTE_SPECS if has_nlte else None,
        P("nu") if has_background else None,
        P(None, None, "nu") if cia_pairs is not None else None,
        P() if cia_pairs is not None else None,
    )
    out_specs = P("ray", "nu")

    fn = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    jitted = jax.jit(fn)

    def apply(nu_grid, lines, cg: PathCG, nlte=None, I_bg=None, nu_off=None,
              cia=None):
        if nu_off is None:
            # f64 grids lose nothing here; f32 callers should stage nu_off
            # from float64 (see DeviceLines docstring).
            nu_off = nu_grid - lines.nu_ref.astype(nu_grid.dtype)
        assert (cia is not None) == (cia_pairs is not None), \
            "pass cia iff the fn was built with cia_pairs"
        cia_tab = cia.tables if cia is not None else None
        cia_tg = cia.T_grid if cia is not None else None
        return jitted(nu_grid, nu_off, lines, cg.u, cg.T_sp, cg.p_sp,
                      cg.p_self_sp, cg.T_air, cg.u_air, cg.uu_air,
                      cg.seg_layer, nlte, I_bg, cia_tab, cia_tg)

    return apply


def stage_sharded(mesh: Mesh, nu_grid, lines: DeviceLines, cg: PathCG,
                  nlte: Optional[DeviceNLTE] = None,
                  I_bg: Optional[jnp.ndarray] = None,
                  cia=None):
    """device_put every input with its mesh sharding (explicit layout — the
    collectives then run without any resharding).  Lines in the nu-halo
    layout (2-D per-line fields from :func:`partition_lines_by_nu`) get the
    halo specs automatically.  Pass ``cia`` (ops.cia.DeviceCIA) to also
    stage the continuum tables (sharded over 'nu')."""
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    nu_s = put(nu_grid, P("nu"))
    lspecs = (HALO_LINES_SPECS if jnp.ndim(lines.nu0) == 2 else LINES_SPECS)
    lines_s = DeviceLines(*[
        put(getattr(lines, f), getattr(lspecs, f))
        for f in DeviceLines._fields
    ])
    cg_s = PathCG(
        u=put(cg.u, P("ray")), T_sp=put(cg.T_sp, P("ray")),
        p_sp=put(cg.p_sp, P("ray")), p_self_sp=put(cg.p_self_sp, P("ray")),
        T_air=put(cg.T_air, P("ray")), seg_layer=put(cg.seg_layer, P()),
        seg_count=cg.seg_count, is_limb=cg.is_limb,
        u_air=put(cg.u_air, P("ray")), uu_air=put(cg.uu_air, P("ray")),
    )
    nlte_s = None if nlte is None else DeviceNLTE(
        e_level=put(nlte.e_level, P()), t_vib=put(nlte.t_vib, P()))
    bg_s = None if I_bg is None else put(I_bg, P("nu"))
    if cia is None:
        return nu_s, lines_s, cg_s, nlte_s, bg_s
    cia_s = cia._replace(tables=put(cia.tables, P(None, None, "nu")),
                         T_grid=put(cia.T_grid, P()))
    return nu_s, lines_s, cg_s, nlte_s, bg_s, cia_s


# Pad-line parameter fills: zero strength makes a pad line exactly inert
# under the linear accumulation contract; the width/mass fills keep its
# (unused) Voigt arguments in normal float range.  The CENTER fill must be
# a FAR sentinel (beyond any band, like the kernels' internal padding), NOT
# 0.0: a mid-band pad breaks the sorted-centers invariant (C1) that BOTH
# the host-side window binary search (pallas_opacity._block_windows) and
# the in-kernel endpoint-based block region dispatch rely on — a 0.0 pad
# ending a 256-line block silently dropped real blocks from the windows
# and mis-dispatched overlapping blocks to the far-wing formula
# (round-3 code-review finding; regression-tested in
# test_sharded_forward.py::test_padded_partition_multi_block_parity).
_PAD_NU0_FAR = 1.0e7
_PAD_FILLS = dict(
    nu0=_PAD_NU0_FAR, sw=0.0, elower=0.0, gamma_air=1e-3, gamma_self=1e-3,
    n_air=0.5, delta_air=0.0, mass_amu=40.0, species_idx=0,
    level_upper=-1, level_lower=-1,
)


def pad_lines_for_mesh(lines: DeviceLines, n_shards: int) -> DeviceLines:
    """Pad the line axis to a multiple of the line-mesh size with zero-
    strength lines (harmless under the linear accumulation contract)."""
    L = lines.n_lines
    Lp = ((L + n_shards - 1) // n_shards) * n_shards
    pad = Lp - L
    if pad == 0:
        return lines
    return lines._replace(**{
        f: jnp.pad(getattr(lines, f), (0, pad), constant_values=fill)
        for f, fill in _PAD_FILLS.items()
    })


def partition_lines_by_nu(
    lines: DeviceLines,
    nu_host,
    n_nu: int,
    *,
    cutoff_cm1: Optional[float] = 25.0,
    line_shards: int = 1,
    round_to: int = 128,
) -> DeviceLines:
    """Host-side owner-shard line partition for the nu-halo tier (C22/C25).

    Each line is assigned to the nu shard whose grid interval contains its
    (unshifted) center; per-shard slices are padded to a common Lmax (a
    multiple of ``round_to * line_shards``) with zero-strength lines.  The
    result's per-line fields carry a leading [n_nu] owner axis and ship with
    :func:`stage_sharded` under ``HALO_LINES_SPECS``.

    Exactness: a line's wing reaches at most the ADJACENT shard, enforced by
    the ``cutoff <= shard width`` assertion (halo.nu_shard_edges); lines
    whose centers fall outside the grid attach to the first/last shard.
    """
    import numpy as np

    from spectrobot_tpu.parallel.halo import nu_shard_edges

    nu_host = np.asarray(nu_host, np.float64)
    edges = nu_shard_edges(nu_host, n_nu, cutoff_cm1)
    # Centers in absolute coordinates (nu0 is an offset from nu_ref; the
    # partition is host float64, so no precision is lost).
    nu0_abs = np.asarray(lines.nu0, np.float64) + float(lines.nu_ref)
    assert np.all(np.diff(nu0_abs) >= 0), "line list must be nu0-sorted (C1)"
    cuts = np.concatenate([[0], np.searchsorted(nu0_abs, edges[1:-1]),
                           [len(nu0_abs)]])
    counts = np.diff(cuts)
    m = round_to * max(line_shards, 1)
    Lmax = max(int(counts.max()), 1)
    Lmax = ((Lmax + m - 1) // m) * m

    out = {}
    for f, fill in _PAD_FILLS.items():
        a = np.asarray(getattr(lines, f))
        buf = np.full((n_nu, Lmax), fill, dtype=a.dtype)
        for k in range(n_nu):
            seg = a[cuts[k]:cuts[k + 1]]
            buf[k, :len(seg)] = seg
        out[f] = jnp.asarray(buf)
    return lines._replace(**out)
