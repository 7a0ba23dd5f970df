"""Coarse node-grid retrieval parameter basis (round-4 review item 3).

Reference-class OE codes retrieve on a coarse node grid mapped to model
levels (SpectRobot's bayes-set parameterisation [TK], SURVEY.md 1.2/3 C16).
Contract tested here:

* the node->level map is exactly np.interp (hat functions, constant
  extrapolation);
* a retrieval on N nodes converges, its Jacobian/posterior shrink to N
  columns per quantity, and it matches the fine-grid retrieval within the
  posterior error at the nodes;
* the map composes with the mesh path (parallel/oe.py ``state_map``) with
  Jacobian parity against the dense jacfwd of forward(expand(state)).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.retrieval.state import (
    NodeBasis, build_forward, flatten_state, node_level_matrix,
)


def test_node_level_matrix_is_interp():
    rng = np.random.default_rng(0)
    z_lev = np.sort(rng.uniform(0.0, 80e3, 40))
    z_nodes = np.linspace(5e3, 70e3, 7)   # levels extend beyond the nodes
    M = node_level_matrix(z_lev, z_nodes)
    vals = rng.normal(size=7)
    np.testing.assert_allclose(M @ vals, np.interp(z_lev, z_nodes, vals),
                               rtol=0, atol=1e-12)
    # Hat-function structure: rows are convex combinations.
    assert np.all(M >= 0)
    np.testing.assert_allclose(M.sum(axis=1), 1.0, atol=1e-12)


def test_node_level_matrix_validation():
    with pytest.raises(ValueError, match="increasing"):
        node_level_matrix(np.linspace(0, 1, 5), np.array([0.0, 2.0, 1.0]))
    with pytest.raises(ValueError, match="at least 2"):
        node_level_matrix(np.linspace(0, 1, 5), np.array([0.5]))


def test_node_basis_expand_matches_interp():
    from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
    atm = mars_standard_atmosphere(n_lev=16, z_top=60e3)
    nb = NodeBasis.uniform(atm, 5)
    state_n = nb.init_state(atm, ["CO2"])
    lev = nb.expand(state_n)
    assert lev["T"].shape == (16,)
    # A profile that IS piecewise linear between the nodes round-trips.
    z = np.asarray(atm.z)
    lin = np.interp(z, np.asarray(nb.z_nodes),
                    np.asarray(state_n["T"], np.float64))
    np.testing.assert_allclose(np.asarray(lev["T"]), lin, rtol=1e-6)


def _cli_retrieve(tmp_path, tag, extra_overrides=()):
    from spectrobot_tpu.cli import main
    cfg = tmp_path / f"{tag}.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 160
[scene]
n_levels = 12
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0, 40.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 40
[compute]
dtype = "float64"
chunk = 128
[retrieval]
max_iter = 10
[run]
output_dir = "{tmp_path}/{tag}"
""")
    args = ["retrieve", str(cfg)]
    for ov in extra_overrides:
        args += ["-o", ov]
    assert main(args) == 0
    with np.load(f"{tmp_path}/{tag}/retrieval.npz") as z:
        return {k: z[k] for k in
                ("x", "S_hat", "A_kernel", "converged", "chi2")}


def test_cli_node_retrieval_converges_and_matches_fine(tmp_path, capsys):
    """A 12-level scene retrieved on 5 altitude nodes: converges, the
    Jacobian/posterior shrink to 5 parameters, and the retrieved T at the
    node altitudes matches the fine-grid retrieval within the combined
    posterior error (round-4 review item 3 done-criterion)."""
    fine = _cli_retrieve(tmp_path, "fine")
    node = _cli_retrieve(tmp_path, "node", ["retrieval.n_nodes=5"])
    capsys.readouterr()
    assert fine["x"].shape == (12,)
    assert node["x"].shape == (5,)                  # parameters shrank
    assert node["S_hat"].shape == (5, 5)
    assert node["A_kernel"].shape == (5, 5)
    assert bool(node["converged"])
    # Compare at the node altitudes within combined 3-sigma posterior.
    z_lev = np.linspace(0.0, 60e3, 12)
    z_nodes = np.linspace(0.0, 60e3, 5)
    T_fine_at_nodes = np.interp(z_nodes, z_lev, fine["x"])
    sig_node = np.sqrt(np.maximum(np.diag(node["S_hat"]), 0.0))
    sig_fine = np.sqrt(np.maximum(np.diag(fine["S_hat"]), 0.0))
    sig_fine_at_nodes = np.interp(z_nodes, z_lev, sig_fine)
    tol = 3.0 * np.hypot(sig_node, sig_fine_at_nodes) + 1e-6
    assert np.all(np.abs(node["x"] - T_fine_at_nodes) < tol), (
        node["x"], T_fine_at_nodes, tol)


def test_cli_node_alt_km_and_validation(tmp_path, capsys):
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "na.toml"
    cfg.write_text("""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 160
[scene]
n_levels = 8
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 30
[compute]
dtype = "float64"
[retrieval]
max_iter = 6
""" + f"[run]\noutput_dir = \"{tmp_path}/na\"\n")
    with pytest.raises(ValueError, match="n_nodes"):
        main(["retrieve", str(cfg), "-o", "retrieval.n_nodes=1"])
    assert main(["retrieve", str(cfg), "-o",
                 "retrieval.node_alt_km=[0.0, 20.0, 45.0]"]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/na/retrieval.npz") as z:
        assert z["x"].shape == (3,)


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs 8 emulated devices")
def test_node_basis_through_mesh():
    """state_map composes with make_sharded_oe: the sharded forward and
    all_gather Jacobian in NODE space match the dense single-device
    forward(expand(state)) and its jacfwd (the map applied before
    apply_state — no new collectives)."""
    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import co2_15um_band
    from spectrobot_tpu.ops.ils import ils_matrix
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu.parallel.mesh import make_mesh
    from spectrobot_tpu.parallel.oe import make_sharded_oe

    atm = mars_standard_atmosphere(n_lev=10, z_top=60e3)
    dl = device_lines_from_linelist(co2_15um_band(j_max=8), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(645.0, 690.0, 256))
    h_t = jnp.asarray([6e3, 14e3, 22e3, 30e3])
    W = jnp.asarray(ils_matrix(np.asarray(nu),
                               np.linspace(648.0, 688.0, 24), fwhm=1.0))

    nb = NodeBasis.uniform(atm, 4)
    state0 = nb.init_state(atm, [])
    x0, unravel = flatten_state(state0)
    assert x0.shape == (4,)

    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=h_t,
                        ils_W=W, n_sub=2, variant="humlicek4",
                        cutoff_cm1=25.0, chunk=128)
    fwd_flat = jax.jit(lambda x: fwd(nb.expand(unravel(x))))
    K_ref = np.asarray(jax.jacfwd(fwd_flat)(x0), np.float64)

    mesh = make_mesh((2, 2, 2), jax.devices()[:8])
    oe = make_sharded_oe(
        mesh, atm, dl, nu, ["CO2"], MARS, h_t, state_template=state0,
        ils_W=W, n_sub=2, variant="humlicek4", cutoff_cm1=25.0, chunk=128,
        state_map=nb.expand)
    np.testing.assert_allclose(np.asarray(oe.forward_flat(x0)),
                               np.asarray(fwd_flat(x0)), rtol=1e-12)
    K_sh = np.asarray(oe.jacobian(jnp.asarray(x0)))
    assert K_sh.shape == K_ref.shape == (24 * 4, 4)
    np.testing.assert_allclose(K_sh, K_ref, rtol=1e-9, atol=1e-16)
