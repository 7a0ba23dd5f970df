"""Distributed OE/LM retrieval over the 8-device emulated mesh (C26
integrated with C16 — the round-2 production path, parallel/oe.py).

Parity contract: the sharded normal equations (psum-assembled on the
(ray, line, nu) mesh) and the full sharded LM retrieval must match the
single-device path to float64 roundoff.  The all_gather Jacobian is checked
against the dense ``jax.jacfwd`` of the unsharded forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, co_fundamental
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.parallel.mesh import make_mesh
from spectrobot_tpu.parallel.oe import make_sharded_oe
from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu.retrieval.state import (
    build_forward, flatten_state, make_state,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 emulated devices")

SPECIES = ["CO2", "CO"]


@pytest.fixture(scope="module")
def scene():
    atm = mars_standard_atmosphere(n_lev=6, z_top=60e3)
    ll = co2_15um_band(j_max=8)
    co = co_fundamental(j_max=6)
    co.nu0[:] = co.nu0 - 2143.27 + 655.0
    ll = ll.concat(co)
    dl = device_lines_from_linelist(ll, [(2, 1), (5, 1)], dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(645.0, 690.0, 256))
    h_t = jnp.asarray([6e3, 14e3, 22e3, 30e3])
    chans = np.linspace(648.0, 688.0, 24)
    W = jnp.asarray(ils_matrix(np.asarray(nu), chans, fwhm=1.0))
    return atm, dl, nu, h_t, W


def _single_device(scene, ils=True):
    atm, dl, nu, h_t, W = scene
    fwd = build_forward(atm, dl, nu, SPECIES, MARS, tangent_heights_m=h_t,
                        ils_W=W if ils else None, n_sub=2,
                        variant="humlicek4", cutoff_cm1=25.0, chunk=128)
    state0 = make_state(atm, ["CO"])
    x0, unravel = flatten_state(state0)
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
    return fwd_flat, jac, x0, state0


def _sharded(scene, mesh_shape=(2, 2, 2), ils=True, engine="jnp",
             nu_halo=False, cutoff_cm1=25.0):
    atm, dl, nu, h_t, W = scene
    mesh = make_mesh(mesh_shape, jax.devices()[: int(np.prod(mesh_shape))])
    state0 = make_state(atm, ["CO"])
    oe = make_sharded_oe(
        mesh, atm, dl, nu, SPECIES, MARS, h_t, state_template=state0,
        ils_W=W if ils else None, n_sub=2, variant="humlicek4",
        cutoff_cm1=cutoff_cm1, chunk=128, engine=engine,
        interpret=engine == "pallas", nu_halo=nu_halo)
    x0, _ = flatten_state(state0)
    return oe, x0


def test_sharded_forward_matches(scene):
    fwd_flat, _, x0, _ = _single_device(scene)
    oe, x0s = _sharded(scene)
    np.testing.assert_allclose(np.asarray(x0s), np.asarray(x0), rtol=0)
    y_ref = np.asarray(fwd_flat(x0))
    y_sh = np.asarray(oe.forward_flat(x0))
    np.testing.assert_allclose(y_sh, y_ref, rtol=1e-12, atol=0)


def test_sharded_normal_equations_match_dense(scene):
    fwd_flat, jac, x0, _ = _single_device(scene)
    oe, _ = _sharded(scene)

    y = np.asarray(fwd_flat(x0)) * 1.01 + 1e-9       # synthetic residual
    sigma = np.full(y.shape, 0.002 * y.max())
    oe.bind_observation(y, sigma)

    F, H, g = oe.normal_eqs(jnp.asarray(x0))
    K = np.asarray(jac(x0), np.float64)
    w = 1.0 / sigma.astype(np.float64) ** 2
    KtW = K.T * w[None, :]
    H_ref = KtW @ K
    g_ref = KtW @ (y - np.asarray(fwd_flat(x0), np.float64))
    np.testing.assert_allclose(np.asarray(H), H_ref, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-9)

    # The all_gather Jacobian is the dense Jacobian, row order included.
    K_sh = np.asarray(oe.jacobian(jnp.asarray(x0)))
    np.testing.assert_allclose(K_sh, K, rtol=1e-9, atol=1e-16)


def test_sharded_jacobian_row_order_no_ils(scene):
    """Without ILS the rows carry BOTH mesh axes ('ray', 'nu') — the
    all_gather must reassemble the (ray-major, nu-minor) flat order."""
    fwd_flat, jac, x0, _ = _single_device(scene, ils=False)
    oe, _ = _sharded(scene, ils=False)
    y_ref = np.asarray(fwd_flat(x0))
    np.testing.assert_allclose(np.asarray(oe.forward_flat(x0)), y_ref,
                               rtol=1e-12)
    K = np.asarray(jac(x0))
    K_sh = np.asarray(oe.jacobian(jnp.asarray(x0)))
    np.testing.assert_allclose(K_sh, K, rtol=1e-9, atol=1e-16)


@pytest.mark.parametrize("mesh_shape,nu_halo", [
    ((2, 2, 2), False),   # Pallas kernel through the line-psum tier
    ((1, 2, 4), True),    # Pallas kernel + nu-halo owner-shard distribution
])
def test_sharded_pallas_engine_matches(scene, mesh_shape, nu_halo):
    """round-2 review item 1 'done' criterion: the mesh forward AND the
    fused-basis analytic Jacobian (ops/pallas_opacity.py basis kernels) run
    THROUGH shard_map with engine='pallas' (interpret mode on the emulated
    CPU mesh) and match the single-device pallas path to the f32
    accumulation-order level."""
    atm, dl, nu, h_t, W = scene
    cut = 5.0  # halo exactness: cutoff <= shard width (45 cm-1 / 4 shards)
    fwd = build_forward(atm, dl, nu, SPECIES, MARS, tangent_heights_m=h_t,
                        ils_W=W, n_sub=2, variant="humlicek4",
                        cutoff_cm1=cut, chunk=128, engine="pallas",
                        interpret=True)
    state0 = make_state(atm, ["CO"])
    x0, unravel = flatten_state(state0)
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    y_ref = np.asarray(fwd_flat(x0))
    K_ref = np.asarray(jax.jacfwd(fwd_flat)(x0))

    oe, _ = _sharded(scene, mesh_shape, engine="pallas", nu_halo=nu_halo,
                     cutoff_cm1=cut)
    y = np.asarray(oe.forward_flat(x0))
    K = np.asarray(oe.jacobian(jnp.asarray(x0)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-6,
                               atol=np.abs(y_ref).max() * 1e-7)
    np.testing.assert_allclose(K, K_ref, rtol=2e-6,
                               atol=np.abs(K_ref).max() * 2e-6)

    # The normal equations assemble from the same fused-basis Jacobian.
    sigma = np.full(y_ref.shape, 0.002 * y_ref.max())
    oe.bind_observation(y_ref * 1.01, sigma)
    F, H, g = oe.normal_eqs(jnp.asarray(x0))
    w = 1.0 / sigma.astype(np.float64) ** 2
    KtW = K_ref.astype(np.float64).T * w[None, :]
    np.testing.assert_allclose(np.asarray(H), KtW @ K_ref, rtol=2e-5)


def test_sharded_nadir_matches_single_device(scene):
    """Nadir x mesh (round-2 review item 8): the mesh forward and
    Jacobian over nadir pixels (sec_theta on the 'ray' axis, grey surface
    with reflected downwelling) match the single-device nadir model."""
    atm, dl, nu, _h_t, W = scene
    sec = jnp.asarray([1.0, 1.15, 1.3, 1.5])
    fwd = build_forward(atm, dl, nu, SPECIES, MARS, sec_theta=sec,
                        T_surface=235.0, ils_W=W, n_sub=2, chunk=128)
    state0 = make_state(atm, ["CO"])
    x0, unravel = flatten_state(state0)
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    y_ref = np.asarray(fwd_flat(x0))
    K_ref = np.asarray(jax.jacfwd(fwd_flat)(x0))

    mesh = make_mesh((2, 2, 2))
    oe = make_sharded_oe(
        mesh, atm, dl, nu, SPECIES, MARS, state_template=state0,
        ils_W=W, n_sub=2, chunk=128, sec_theta=sec, T_surface=235.0,
        emissivity=1.0)
    np.testing.assert_allclose(np.asarray(oe.forward_flat(x0)), y_ref,
                               rtol=1e-10, atol=np.abs(y_ref).max() * 1e-12)
    np.testing.assert_allclose(np.asarray(oe.jacobian(jnp.asarray(x0))),
                               K_ref, rtol=1e-8, atol=1e-16)

    # Grey surface: the reflected downwelling is computed INSIDE the mesh.
    fwd_g = build_forward(atm, dl, nu, SPECIES, MARS, sec_theta=sec,
                          T_surface=235.0, ils_W=W, n_sub=2, chunk=128)
    # build_forward has no emissivity knob (nadir_radiance does); compare
    # against the library path directly.
    from spectrobot_tpu.forward.geometry import nadir_path_cg
    from spectrobot_tpu.forward.limb import nadir_radiance
    from spectrobot_tpu.ops.ils import apply_ils
    cg = nadir_path_cg(atm, SPECIES, sec, 2)
    y_grey = np.asarray(apply_ils(
        nadir_radiance(nu, dl, cg, 235.0, emissivity=0.85, chunk=128),
        W)).reshape(-1)
    oe_g = make_sharded_oe(
        mesh, atm, dl, nu, SPECIES, MARS, state_template=state0,
        ils_W=W, n_sub=2, chunk=128, sec_theta=sec, T_surface=235.0,
        emissivity=0.85)
    np.testing.assert_allclose(np.asarray(oe_g.forward_flat(x0)), y_grey,
                               rtol=1e-10, atol=np.abs(y_grey).max() * 1e-12)


def test_sharded_fov_retrieval_matches(scene):
    """FOV x mesh (round-2 review item 7): field-of-view smearing over a
    fine tangent-height ladder composes with the mesh — the FOV mixes the
    sharded 'ray' axis outside the shard_map, dropping it from the Jacobian
    row axes."""
    from spectrobot_tpu.ops.ils import fov_matrix

    atm, dl, nu, _h_t, W = scene
    h_fine = jnp.asarray(np.linspace(4e3, 32e3, 8))      # ladder: 8 % 2 == 0
    h_obs = np.array([10e3, 18e3, 26e3])
    V = jnp.asarray(fov_matrix(np.asarray(h_fine), h_obs, fwhm_m=6e3))

    fwd = build_forward(atm, dl, nu, SPECIES, MARS, tangent_heights_m=h_fine,
                        ils_W=W, fov_V=V, n_sub=2, chunk=128)
    state0 = make_state(atm, ["CO"])
    x0, unravel = flatten_state(state0)
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    y_ref = np.asarray(fwd_flat(x0))
    K_ref = np.asarray(jax.jacfwd(fwd_flat)(x0))

    mesh = make_mesh((2, 2, 2))
    oe = make_sharded_oe(
        mesh, atm, dl, nu, SPECIES, MARS, h_fine, state_template=state0,
        ils_W=W, fov_V=V, n_sub=2, chunk=128)
    assert oe.row_axes == ()      # ILS mixed 'nu', FOV mixed 'ray'
    np.testing.assert_allclose(np.asarray(oe.forward_flat(x0)), y_ref,
                               rtol=1e-10, atol=np.abs(y_ref).max() * 1e-12)
    np.testing.assert_allclose(np.asarray(oe.jacobian(jnp.asarray(x0))),
                               K_ref, rtol=1e-8, atol=1e-16)

    # Normal equations through the replicated-rows path.
    sigma = np.full(y_ref.shape, 0.002 * y_ref.max())
    oe.bind_observation(y_ref * 1.01, sigma)
    _, H, _ = oe.normal_eqs(jnp.asarray(x0))
    w = 1.0 / sigma.astype(np.float64) ** 2
    H_ref = (K_ref.astype(np.float64).T * w[None, :]) @ K_ref
    np.testing.assert_allclose(np.asarray(H), H_ref, rtol=1e-9)


def test_sharded_retrieval_matches_single_device(scene, tmp_path):
    atm, dl, nu, h_t, W = scene
    rng = np.random.default_rng(11)

    fwd_flat, jac, x_true, state0 = _single_device(scene)
    y_clean = np.asarray(fwd_flat(x_true))
    sigma = np.full(y_clean.shape, 0.005 * y_clean.max())
    y_obs = y_clean + sigma * rng.standard_normal(y_clean.shape)

    n_lev = atm.n_lev
    x0 = np.asarray(x_true).copy()
    x0[:n_lev] += 6.0                       # biased T start
    S_a = np.diag(np.concatenate([np.full(n_lev, 10.0 ** 2),
                                  np.full(n_lev, np.log(5.0) ** 2)]))
    cfg = OEConfig(max_iter=8, chi2_rel_tol=1e-4)

    res_ref = retrieve(fwd_flat, jac, jnp.asarray(y_obs), jnp.asarray(x0),
                       jnp.asarray(x0), S_a, jnp.asarray(sigma), cfg)

    oe, _ = _sharded(scene)
    oe.bind_observation(y_obs, sigma)
    res_sh = retrieve(oe.forward_flat, oe.jacobian, jnp.asarray(y_obs),
                      jnp.asarray(x0), jnp.asarray(x0), S_a,
                      jnp.asarray(sigma), cfg, normal_eqs=oe.normal_eqs)

    assert res_sh.converged == res_ref.converged
    assert res_sh.n_iter == res_ref.n_iter
    np.testing.assert_allclose(res_sh.x, res_ref.x, rtol=1e-8)
    np.testing.assert_allclose(res_sh.chi2, res_ref.chi2, rtol=1e-8)
    np.testing.assert_allclose(res_sh.S_hat, res_ref.S_hat, rtol=1e-6)
    np.testing.assert_allclose(res_sh.dof, res_ref.dof, rtol=1e-8)
