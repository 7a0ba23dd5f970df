"""Retrieval state vector and forward-model builder (C15-C17, SURVEY.md).

The reference (fedef17/SpectRobot ``spect_main_module`` bayes/retrieval
classes [SURVEY.md 1.2]) retrieves temperature and VMR profiles from limb
scans.  The state is a pytree
``{"T": [n_lev], "ln_vmr": {species: [n_lev]}}`` flattened with
``ravel_pytree``; the forward model is ONE jit-able function state -> y
(concatenated channel radiances over all rays), differentiable end-to-end, so
Jacobians come from ``jax.jacfwd`` (forward-mode: n_x tangents through one
linearised pass) with a finite-difference harness beside it (config 4,
BASELINE.json:10).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from spectrobot_tpu.data.atmosphere import Atmosphere, Planet
from spectrobot_tpu.data.nlte import DeviceNLTE
from spectrobot_tpu.forward.geometry import limb_path_cg, nadir_path_cg
from spectrobot_tpu.forward.limb import limb_radiance, nadir_radiance
from spectrobot_tpu.ops.ils import apply_ils
from spectrobot_tpu.ops.strengths import DeviceLines


def make_state(atm: Atmosphere, retrieve_vmr: Sequence[str],
               T_surface: Optional[float] = None,
               retrieve_temperature: bool = True) -> Dict:
    """Initial state from an atmosphere: kinetic T profile (unless
    ``retrieve_temperature=False`` — VMR-only retrievals hold T fixed, as the
    reference's bayes sets allow per-quantity switches) + log-VMR profiles of
    the retrieved species (log keeps VMRs positive under LM steps).
    Pass ``T_surface`` to ALSO retrieve the surface temperature (nadir)."""
    state: Dict = {
        "ln_vmr": {s: jnp.log(atm.vmr[s]) for s in retrieve_vmr},
    }
    if retrieve_temperature:
        state["T"] = atm.T
    if T_surface is not None:
        state["T_surface"] = jnp.asarray(T_surface, atm.T.dtype)
    return state


def apply_state(atm: Atmosphere, state: Dict) -> Atmosphere:
    out = atm.with_temperature(state["T"]) if "T" in state else atm
    for s, lv in state["ln_vmr"].items():
        out = out.with_vmr(s, jnp.exp(lv))
    return out  # (surface parameters are consumed by the forward, not atm)


# ---------------------------------------------------------------------------
# Coarse retrieval parameter basis (round-4 review item 3)
# ---------------------------------------------------------------------------
#
# Reference-class OE codes retrieve on a coarse NODE grid mapped to model
# levels (SpectRobot's bayes-set parameterisation [TK], SURVEY.md 1.2/3
# C16): fewer, less degenerate parameters, cheaper Jacobians, priors on
# physically meaningful scales.  Form: the node->level map is
# ONE static matmul applied to the state pytree BEFORE apply_state, so
# Jacobians flow through it automatically (jvp of a linear map is the map)
# and the mesh path needs no new collectives (the expansion is replicated,
# tiny work).


def node_level_matrix(z_lev: "np.ndarray", z_nodes: "np.ndarray"):
    """[n_lev, n_nodes] piecewise-linear interpolation matrix: profile at
    the model levels = M @ profile at the retrieval nodes (hat-function
    weights; constant extrapolation beyond the end nodes — exactly
    np.interp semantics, as a matrix so it is differentiable/static)."""
    import numpy as np
    z_lev = np.asarray(z_lev, np.float64)
    z_nodes = np.asarray(z_nodes, np.float64)
    if z_nodes.ndim != 1 or len(z_nodes) < 2:
        raise ValueError("need at least 2 retrieval nodes")
    if not np.all(np.diff(z_nodes) > 0):
        raise ValueError("retrieval node altitudes must be strictly "
                         "increasing")
    n_lev, n_nodes = len(z_lev), len(z_nodes)
    M = np.zeros((n_lev, n_nodes))
    j = np.clip(np.searchsorted(z_nodes, z_lev, side="right") - 1, 0,
                n_nodes - 2)
    t = (z_lev - z_nodes[j]) / (z_nodes[j + 1] - z_nodes[j])
    t = np.clip(t, 0.0, 1.0)                     # constant extrapolation
    M[np.arange(n_lev), j] = 1.0 - t
    M[np.arange(n_lev), j + 1] += t
    return M


class NodeBasis:
    """Linear node->level state map for coarse-grid retrieval.

    ``expand(state)`` maps a node-space state pytree (profiles of length
    n_nodes) to the level-space pytree the forward consumes; scalar blocks
    (T_surface) pass through.  Compose as ``forward(expand(state))`` — or
    pass ``state_map=nb.expand`` to parallel.oe.make_sharded_oe.
    """

    def __init__(self, z_lev, z_nodes):
        import numpy as np
        self.z_lev = np.asarray(z_lev, np.float64)
        self.z_nodes = np.asarray(z_nodes, np.float64)
        # Host float64 master copy; cast per state dtype at expand time (a
        # baked f32 copy would silently degrade float64 retrievals).
        self.M = node_level_matrix(self.z_lev, self.z_nodes)
        self.n_nodes = int(self.M.shape[1])

    @classmethod
    def uniform(cls, atm: Atmosphere, n_nodes: int) -> "NodeBasis":
        import numpy as np
        z = np.asarray(atm.z, np.float64)
        return cls(z, np.linspace(z[0], z[-1], int(n_nodes)))

    def init_state(self, atm: Atmosphere, retrieve_vmr: Sequence[str],
                   T_surface: Optional[float] = None,
                   retrieve_temperature: bool = True) -> Dict:
        """Node-space initial state: the atmosphere's profiles sampled at
        the node altitudes (the node analog of :func:`make_state`)."""
        state: Dict = {
            "ln_vmr": {s: self.project(jnp.log(atm.vmr[s]))
                       for s in retrieve_vmr},
        }
        if retrieve_temperature:
            state["T"] = self.project(atm.T)
        if T_surface is not None:
            state["T_surface"] = jnp.asarray(T_surface, atm.T.dtype)
        return state

    def project(self, profile_lev) -> jnp.ndarray:
        """Level profile -> node values (sampled at node altitudes)."""
        import numpy as np
        return jnp.asarray(
            np.interp(self.z_nodes, self.z_lev,
                      np.asarray(profile_lev, np.float64)),
            jnp.result_type(profile_lev))

    def expand(self, state: Dict) -> Dict:
        def up(v):
            # HIGHEST: a GPU's default float32 matmul is TF32 (~1e-3
            # relative, ~0.2 K on a 200 K profile).
            return jnp.matmul(jnp.asarray(self.M, v.dtype), v,
                              precision=jax.lax.Precision.HIGHEST)
        out: Dict = {"ln_vmr": {s: up(v)
                                for s, v in state["ln_vmr"].items()}}
        if "T" in state:
            out["T"] = up(state["T"])
        if "T_surface" in state:
            out["T_surface"] = state["T_surface"]
        return out


def build_forward(
    base_atm: Atmosphere,
    lines: DeviceLines,
    nu_grid: jnp.ndarray,
    species: Sequence[str],
    planet: Planet,
    tangent_heights_m: Optional[jnp.ndarray] = None,
    sec_theta: Optional[jnp.ndarray] = None,
    T_surface: Optional[float] = None,
    emissivity: float = 1.0,
    ils_W: Optional[jnp.ndarray] = None,
    fov_V: Optional[jnp.ndarray] = None,
    nlte: Optional[DeviceNLTE] = None,
    n_sub: int = 4,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    analytic_jvp=True,  # True/"fwd" | "rev" | False (ops.opacity._ad_mode)
    nu_off: Optional[jnp.ndarray] = None,
    engine: str = "jnp",
    interpret: bool = False,  # engine='pallas' on CPU (tests)
    cia=None,  # ops.cia.DeviceCIA: additive continuum (differentiable)
    chi=None,  # (ops.chi.ChiProfile, row_mask tuple): wing correction
) -> Callable[[Dict], jnp.ndarray]:
    """Build F: state -> y.

    Limb mode when ``tangent_heights_m`` is given (deep-space background),
    nadir mode when ``sec_theta``/``T_surface`` are given.  ``ils_W`` maps
    the fine grid to instrument channels; ``fov_V`` [n_obs, n_ray] smears a
    fine tangent-height ladder into observed FOVs (ops.ils.fov_matrix) —
    together the full C14 ILS/FOV convolution.  Output y is flattened
    [n_obs_ray * n_chan].
    """
    kw = dict(variant=variant, cutoff_cm1=cutoff_cm1, chunk=chunk,
              analytic_jvp=analytic_jvp, nu_off=nu_off, engine=engine,
              interpret=interpret, cia=cia, chi=chi)

    def forward(state: Dict) -> jnp.ndarray:
        atm = apply_state(base_atm, state)
        if tangent_heights_m is not None:
            cg = limb_path_cg(atm, species, tangent_heights_m, planet, n_sub)
            I = limb_radiance(nu_grid, lines, cg, nlte, **kw)
        else:
            ts = state.get("T_surface", T_surface)  # retrievable (nadir)
            cg = nadir_path_cg(atm, species, sec_theta, n_sub)
            I = nadir_radiance(nu_grid, lines, cg, ts,
                               emissivity=emissivity, nlte=nlte, **kw)
        if fov_V is not None:
            from spectrobot_tpu.ops.ils import apply_fov
            I = apply_fov(I, fov_V)
        if ils_W is not None:
            I = apply_ils(I, ils_W)
        return I.reshape(-1)

    return forward


def build_forward_lut(
    base_atm: Atmosphere,
    lut,  # ops.lut.OpacityLUT | ops.lut.NLTELUT
    species: Sequence[str],
    planet: Planet,
    tangent_heights_m: Optional[jnp.ndarray] = None,
    sec_theta: Optional[jnp.ndarray] = None,
    T_surface: Optional[float] = None,
    emissivity: float = 1.0,
    ils_W: Optional[jnp.ndarray] = None,
    fov_V: Optional[jnp.ndarray] = None,
    nlte: Optional[DeviceNLTE] = None,
    n_sub: int = 4,
    cia=None,
) -> Callable[[Dict], jnp.ndarray]:
    """Build F: state -> y through the (P, T) LUT runtime tier (C9,
    reference call stack 4.3: ``makeLUT*`` then interpolate) — the bilinear
    table interpolation is differentiable in (T, log p) and in the VMR
    state, so jacfwd produces the Jacobian the LM loop needs WITHOUT any
    line summation per iteration (round-2 review item 4: 'the reference
    runs its LUT tier precisely to make retrieval loops cheap').

    ``lut`` is an LTE ``OpacityLUT`` or the per-level-group ``NLTELUT``
    (pass ``nlte`` with the latter so level populations contract against
    the cached coefficient tables).
    """
    from spectrobot_tpu.forward.limb import radiance_from_tau
    from spectrobot_tpu.ops.lut import (
        NLTELUT, layer_tau_lut, layer_tau_nlte_lut,
    )

    nu_grid = lut.nu_grid
    is_nlte_tier = isinstance(lut, NLTELUT)

    def forward(state: Dict) -> jnp.ndarray:
        atm = apply_state(base_atm, state)
        if tangent_heights_m is not None:
            cg = limb_path_cg(atm, species, tangent_heights_m, planet, n_sub)
            ts = None
        else:
            cg = nadir_path_cg(atm, species, sec_theta, n_sub)
            ts = state.get("T_surface", T_surface)
        if is_nlte_tier:
            dtau, dtau_em = layer_tau_nlte_lut(lut, cg, nlte)
        else:
            dtau = dtau_em = layer_tau_lut(lut, cg)
        I = radiance_from_tau(nu_grid, cg, dtau, dtau_em, cia=cia,
                              T_surface=ts, emissivity=emissivity)
        if fov_V is not None:
            from spectrobot_tpu.ops.ils import apply_fov
            I = apply_fov(I, fov_V)
        if ils_W is not None:
            I = apply_ils(I, ils_W)
        return I.reshape(-1)

    return forward


def flatten_state(state: Dict) -> Tuple[jnp.ndarray, Callable]:
    """state pytree <-> flat vector (fixed ordering via ravel_pytree)."""
    flat, unravel = ravel_pytree(state)
    return flat, unravel


def jacobian_fwd(forward_flat: Callable, x: jnp.ndarray) -> jnp.ndarray:
    """Analytic Jacobian K [n_y, n_x] by forward-mode AD (C15)."""
    return jax.jacfwd(forward_flat)(x)


def jacobian_fwd_chunked(forward_flat: Callable, x: jnp.ndarray,
                         chunk: int = 16) -> jnp.ndarray:
    """Analytic Jacobian in tangent CHUNKS — bounds the live tangent batch to
    ``chunk`` columns (SURVEY.md 8.4 hard part 3: 'Jacobian memory —
    forward-mode batching rather than naive reverse-mode').  Same result as
    :func:`jacobian_fwd`; use when n_x x spectrum does not fit in HBM."""
    n_x = x.shape[0]
    eye = jnp.eye(n_x, dtype=x.dtype)
    cols = []
    for s in range(0, n_x, chunk):
        tang = eye[s:s + chunk]

        def one(v):
            return jax.jvp(forward_flat, (x,), (v,))[1]

        cols.append(jax.vmap(one)(tang))         # [chunk, n_y]
    return jnp.concatenate(cols, axis=0).T


def jacobian_fd(forward_flat: Callable, x: jnp.ndarray,
                eps: float = 1e-3) -> jnp.ndarray:
    """Central finite-difference Jacobian — the config-4 cross-check harness
    (BASELINE.json:10).  eps is scaled per-parameter by max(|x_i|, 1)."""
    import numpy as np
    x = np.asarray(x)
    cols = []
    for i in range(x.shape[0]):
        h = eps * max(abs(x[i]), 1.0)
        xp = x.copy(); xp[i] += h
        xm = x.copy(); xm[i] -= h
        cols.append((np.asarray(forward_flat(jnp.asarray(xp)))
                     - np.asarray(forward_flat(jnp.asarray(xm)))) / (2 * h))
    return np.stack(cols, axis=1)
