"""Sharded OE/LM retrieval: the production distributed-inversion path
(C26 integrated with C16, SURVEY.md 4.2; BASELINE.json:5 "assembling
analytic Jacobians for the OE/LM retrieval loop" via allgather, which XLA
hands to NCCL on GPUs).

The reference (fedef17/SpectRobot spect_main_module LM driver [SURVEY.md
1.2]) is single-node; this module is the distributed replacement: the
forward model runs under ``shard_map`` on the (ray, line, nu) mesh
(parallel/sharded.py), the analytic Jacobian is obtained by LINEARISING the
sharded forward once per iteration and scanning unit tangents through the
linearised program (the shared Voigt basis of ops/opacity.py is evaluated
once; each column is one contraction), and the LM normal equations are
assembled on-device with ONE psum over the measurement-sharded axes
(parallel/retrieval.sharded_normal_equations) — O(n_x^2) traffic per
shard, independent of the measurement count.  The full Jacobian matrix is
materialised only when diagnostics ask for it, via
``lax.all_gather`` (parallel/retrieval.allgather_jacobian).

The host-side LM loop stays :func:`spectrobot_tpu.retrieval.oe.retrieve`
(float64 solve); it consumes these callables through its ``normal_eqs``
hook, so checkpointing, JSONL metrics and convergence logic are shared with
the single-device path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from spectrobot_tpu.data.atmosphere import Atmosphere, Planet
from spectrobot_tpu.data.nlte import DeviceNLTE
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.ops.ils import apply_ils
from spectrobot_tpu.ops.strengths import DeviceLines
from spectrobot_tpu.parallel.retrieval import (
    allgather_jacobian, sharded_normal_equations,
)
from spectrobot_tpu.parallel.sharded import (
    pad_lines_for_mesh, partition_lines_by_nu, sharded_radiance_fn,
    stage_sharded,
)
from spectrobot_tpu.retrieval.state import apply_state


class ShardedOE:
    """Bundle of jitted callables driving the distributed LM loop.

    forward_flat(x) -> y        sharded forward, flat measurement vector
    normal_eqs(x)   -> (F, H, g)  F = forward, H = K^T Se^-1 K (psum over
                                  the mesh), g = K^T Se^-1 (y - F)
    jacobian(x)     -> K        full [n_y, n_x] via all_gather
    """

    def __init__(self, forward_flat, normal_eqs, jacobian, n_x: int,
                 mesh: Mesh, row_axes: Tuple[str, ...]):
        self.forward_flat = forward_flat
        self._normal_eqs = normal_eqs
        self.jacobian = jacobian
        self.n_x = n_x
        self.mesh = mesh
        self.row_axes = row_axes
        self._y = None
        self._inv_se = None

    def bind_observation(self, y, noise_sigma) -> None:
        """Fix (y, S_eps^-1) so ``normal_eqs`` matches the retrieve() hook
        signature x -> (F, H, g).

        Stored as HOST numpy (identical on every process): host values
        passed as jit arguments are auto-replicated onto the mesh, which
        keeps this correct in true multi-controller runs — a committed
        single-device jnp array would not span a multi-process mesh.

        dtype note (round-4 review): float64 observations are KEPT f64 on
        the host, but they only stay f64 through jit when the caller runs
        with ``jax.config.update('jax_enable_x64', True)`` (the multihost
        worker does); with x64 disabled JAX downcasts jit arguments to f32
        at entry — enable x64 if the f64 normal-equations path matters.
        """
        dt = (np.float64 if np.asarray(y).dtype == np.float64
              else np.float32)
        if dt == np.float64 and not jax.config.jax_enable_x64:
            import warnings
            warnings.warn(
                "bind_observation received float64 observations but "
                "jax_enable_x64 is off — jit will downcast them to "
                "float32; enable x64 to keep the f64 path", stacklevel=2)
        self._y = np.asarray(y, dt)
        self._inv_se = np.asarray(
            1.0 / np.asarray(noise_sigma, np.float64) ** 2, dt)

    def normal_eqs(self, x):
        assert self._y is not None, "call bind_observation(y, sigma) first"
        return self._normal_eqs(x, self._y, self._inv_se)


def make_sharded_oe(
    mesh: Mesh,
    base_atm: Atmosphere,
    lines: DeviceLines,
    nu_grid: jnp.ndarray,
    species: Sequence[str],
    planet: Planet,
    tangent_heights_m: Optional[jnp.ndarray] = None,
    *,
    state_template: Dict,
    ils_W: Optional[jnp.ndarray] = None,
    fov_V: Optional[jnp.ndarray] = None,
    nlte: Optional[DeviceNLTE] = None,
    n_sub: int = 4,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    nu_off: Optional[jnp.ndarray] = None,
    unravel=None,
    engine: str = "jnp",
    interpret: bool = False,
    nu_halo: bool = False,
    cia=None,
    sec_theta: Optional[jnp.ndarray] = None,
    T_surface=None,
    emissivity: float = 1.0,
    lut=None,
    state_map=None,
    chi=None,
) -> ShardedOE:
    """Build the sharded retrieval callables for a limb scene.

    ``state_template``/``unravel`` come from retrieval.state.make_state +
    flatten_state — the state pytree is REPLICATED (it is tiny); everything
    measurement-sized is sharded.  Shape contract (parallel/sharded.py):
    n_rays % mesh['ray'] == 0 and n_points % mesh['nu'] == 0; the line axis
    is padded (or, with ``nu_halo``, owner-partitioned) here.

    ``engine='pallas'`` runs the opacity stage — primal AND the fused
    analytic-Jacobian basis — on the C5/C6 GPU kernel inside the shard_map
    body (round-2 review item 1); ``interpret=True`` for CPU meshes.
    ``nu_halo=True`` uses the owner-shard + ring-halo line distribution
    (parallel/sharded.py module docstring).  ``cia`` (ops.cia.DeviceCIA)
    adds the collision-induced continuum inside the mesh forward.

    Geometry: limb when ``tangent_heights_m`` is given, NADIR when
    ``sec_theta``/``T_surface`` are (round-2 review item 8 — 'ray'
    shards pixels); ``state_template`` may carry "T_surface" to retrieve
    it.  ``fov_V`` [n_obs, n_ray] smears the fine tangent-height ladder
    into observed fields of view (C14) — like the ILS across 'nu', the FOV
    mixes across the sharded 'ray' axis OUTSIDE the shard_map, so GSPMD
    inserts the gather and the Jacobian row axes drop 'ray'.

    ``lut`` (ops.lut.OpacityLUT / NLTELUT) switches the forward to the
    sharded LUT runtime tier (parallel/sharded_lut.py): tables shard over
    'nu', each LM iteration costs bilinear lookups instead of line sums,
    and ``lines``/``engine``/``nu_halo`` are ignored (no line axis exists).
    """
    if unravel is None:
        from spectrobot_tpu.retrieval.state import flatten_state
        x0, unravel = flatten_state(state_template)
        n_x = int(x0.shape[0])
    else:
        from jax.flatten_util import ravel_pytree
        n_x = int(ravel_pytree(state_template)[0].shape[0])

    if lut is not None:
        dlp = None                       # LUT tier: no line axis at all
    elif nu_halo:
        dlp = partition_lines_by_nu(
            lines, np.asarray(nu_grid), mesh.shape["nu"],
            cutoff_cm1=cutoff_cm1, line_shards=mesh.shape["line"])
    else:
        dlp = pad_lines_for_mesh(lines, mesh.shape["line"])
    is_limb = tangent_heights_m is not None
    assert is_limb or sec_theta is not None, \
        "pass tangent_heights_m (limb) or sec_theta (nadir)"
    cia_pairs = None if cia is None else (cia.pair_a, cia.pair_b)
    if lut is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from spectrobot_tpu.ops.lut import NLTELUT
        from spectrobot_tpu.parallel.sharded_lut import (
            sharded_lut_radiance_fn, stage_lut_sharded,
        )
        nlte_tier = isinstance(lut, NLTELUT)
        assert nlte_tier == (nlte is not None), \
            "pass nlte together with an NLTELUT (and only then)"
        fwd_lut = sharded_lut_radiance_fn(
            mesh, nlte_tier=nlte_tier, has_background=not is_limb,
            cia_pairs=cia_pairs, is_limb=is_limb, emissivity=emissivity)
        lut_s = stage_lut_sharded(mesh, lut)
        rep = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
        nlte_s = None if nlte is None else nlte._replace(
            e_level=rep(nlte.e_level), t_vib=rep(nlte.t_vib))
        cia_s = None if cia is None else cia._replace(
            tables=jax.device_put(
                cia.tables, NamedSharding(mesh, P(None, None, "nu"))),
            T_grid=rep(cia.T_grid))
    else:
        if nu_off is None:
            nu_off = nu_grid - lines.nu_ref.astype(nu_grid.dtype)
        fwd_sharded = sharded_radiance_fn(
            mesh, has_nlte=nlte is not None, has_background=not is_limb,
            variant=variant, cutoff_cm1=cutoff_cm1, chunk=chunk,
            engine=engine, interpret=interpret, nu_halo=nu_halo,
            cia_pairs=cia_pairs, is_limb=is_limb, emissivity=emissivity,
            win_grid=(np.asarray(nu_off) if engine == "pallas" else None),
            win_lines=(np.asarray(dlp.nu0) if engine == "pallas" else None),
            chi=chi)
    # Static inputs staged once with their mesh layout (cg placeholder is
    # discarded — the retrieval recomputes it from the state every call).
    if is_limb:
        cg0 = limb_path_cg(base_atm, species, tangent_heights_m, planet,
                           n_sub)
    else:
        from spectrobot_tpu.forward.geometry import nadir_path_cg
        cg0 = nadir_path_cg(base_atm, species, sec_theta, n_sub)
    if lut is None:
        staged = stage_sharded(mesh, nu_grid, dlp, cg0, nlte=nlte, cia=cia)
        nu_s, lines_s, _, nlte_s, _ = staged[:5]
        cia_s = staged[5] if cia is not None else None

    # Staged mesh inputs are passed to the jitted callables as ARGUMENTS
    # (bound at the python level per call, below), NOT closed over: a
    # closure constant that spans a multi-process mesh is rejected by jax
    # ("closing over non-addressable jax.Array"), so argument-passing is
    # what keeps this module correct under true multi-controller runs
    # (tests/multihost/worker_oe.py).  Outputs are constrained to the
    # REPLICATED layout so the host-side float64 LM loop can read them on
    # every process.
    if lut is not None:
        staged_args = (lut_s, nlte_s, cia_s)
    else:
        staged_args = (nu_s, lines_s, nlte_s, cia_s)

    from jax.sharding import NamedSharding, PartitionSpec as _P
    _replicate = lambda t: jax.tree_util.tree_map(
        lambda a: jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, _P())), t)

    def model(x, *staged):
        state = unravel(x)
        if state_map is not None:
            # Coarse node->level expansion (retrieval.state.NodeBasis):
            # applied BEFORE apply_state, replicated (tiny matmul), so the
            # mesh collectives are untouched and Jacobian columns flow
            # through the linear map automatically.
            state = state_map(state)
        atm = apply_state(base_atm, state)
        if is_limb:
            cg = limb_path_cg(atm, species, tangent_heights_m, planet, n_sub)
            bg = None
        else:
            from spectrobot_tpu.forward.geometry import nadir_path_cg
            from spectrobot_tpu.ops.planck import planck_nu
            cg = nadir_path_cg(atm, species, sec_theta, n_sub)
            ts = state.get("T_surface", T_surface)
            bg = emissivity * planck_nu(nu_grid, ts)
        if lut is not None:
            lut_a, nlte_a, cia_a = staged
            I = fwd_lut(lut_a, cg, nlte_a, I_bg=bg, cia=cia_a)  # [R, P]
        else:
            nu_a, lines_a, nlte_a, cia_a = staged
            I = fwd_sharded(nu_a, lines_a, cg, nlte_a, I_bg=bg,
                            nu_off=nu_off, cia=cia_a)  # [R, P]
        if fov_V is not None:
            from spectrobot_tpu.ops.ils import apply_fov
            I = apply_fov(I, fov_V)
        if ils_W is not None:
            # Mixes across the sharded nu axis — outside the shard_map, so
            # GSPMD inserts the reduce over nu shards automatically.
            I = apply_ils(I, ils_W)
        return I.reshape(-1)

    # Jacobian rows keep the mesh axes their measurement layout still
    # carries: the ILS mixes away 'nu', the FOV mixes away 'ray'.
    row_axes = tuple(
        ax for ax, mixed in (("ray", fov_V is not None),
                             ("nu", ils_W is not None)) if not mixed)
    ne_fn = sharded_normal_equations(mesh, axes=row_axes)
    gather_fn = allgather_jacobian(mesh, axes=row_axes)

    def jac_columns(x, staged):
        """K [n_y, n_x]: vmap the n_x unit tangents through ONE jvp of the
        sharded forward.  Primal-only computations stay unbatched under the
        tangent vmap, so the analytic custom-JVP Voigt basis is evaluated
        once for the whole Jacobian (primal out_axes=None asserts that), and
        with engine='pallas' the custom_vmap rule of the fused tangent
        kernel folds every column into the kernel's row axis
        (ops.opacity._make_tangent_pallas) — the round-2 fused-basis
        economics now running THROUGH the mesh (round-2 review item 1;
        vmap-over-shard_map batches the body, supported since JAX 0.9)."""
        eye = jnp.eye(n_x, dtype=x.dtype)
        F, KT = jax.vmap(lambda v: jax.jvp(lambda xx: model(xx, *staged),
                                           (x,), (v,)),
                         out_axes=(None, 0))(eye)
        return F, KT.T

    def _forward(x, *staged):
        return _replicate(model(x, *staged))

    def _normal_eqs(x, y, inv_se, *staged):
        F, K = jac_columns(x, staged)
        H, g = ne_fn(K, y - F, inv_se)
        return _replicate((F, H, g))

    def _jacobian(x, *staged):
        _, K = jac_columns(x, staged)
        return _replicate(gather_fn(K))

    fwd_jit = jax.jit(_forward)
    ne_jit = jax.jit(_normal_eqs)
    jac_jit = jax.jit(_jacobian)

    # Host-level binding: x must be a HOST value so it auto-replicates onto
    # the mesh as a jit argument in multi-controller runs — but only convert
    # when it is not already one (np.asarray on a committed device array
    # forces a device->host transfer + sync per LM iteration; round-4
    # review).  retrieve() passes numpy, so the common path is free.
    def _host(x):
        return x if isinstance(x, np.ndarray) else np.asarray(x)

    oe = ShardedOE(
        forward_flat=lambda x: fwd_jit(_host(x), *staged_args),
        normal_eqs=lambda x, y, se: ne_jit(_host(x), y, se, *staged_args),
        jacobian=lambda x: jac_jit(_host(x), *staged_args),
        n_x=n_x, mesh=mesh, row_axes=row_axes)
    return oe
