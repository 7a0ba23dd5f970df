"""The FULL feature matrix composed through the mesh ONCE (round-4 review
item 6): non-LTE x CIA x FOV x limb x engine='pallas' x nu_halo through
make_sharded_oe, retrieved to convergence, with forward/Jacobian parity
against the single-device path.  Until round 5 each feature had its own
8-device test but no single test composed them all."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spectrobot_tpu.data.atmosphere import MARS
from spectrobot_tpu.parallel.mesh import make_mesh
from spectrobot_tpu.parallel.oe import make_sharded_oe
from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu.retrieval.state import build_forward, flatten_state, make_state

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 emulated devices")


@pytest.fixture(scope="module")
def composed():
    from __graft_entry__ import _composed_scene
    # Smaller than the dryrun (this test runs the LM loop to convergence
    # twice) but every feature present and every mesh axis >1.
    return _composed_scene(n_lev=8, n_nu=512, n_fine=4, j_max=8,
                           dtype=jnp.float64)


def _single(composed):
    atm, dl, nlte, cia, nu, h_fine, fov_V, n_obs = composed
    # Same engine as the mesh body (pallas, f32 kernel) so parity is
    # engine-noise-free; the engine itself is validated against jnp/f64
    # elsewhere (tests/test_pallas_opacity.py, test_chi.py).
    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=h_fine,
                        fov_V=fov_V, nlte=nlte, cia=cia, n_sub=2,
                        variant="humlicek4", cutoff_cm1=8.0, chunk=128,
                        engine="pallas", interpret=True)
    state0 = make_state(atm, [])
    x0, unravel = flatten_state(state0)
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
    return fwd_flat, jac, x0, state0


def _sharded(composed):
    atm, dl, nlte, cia, nu, h_fine, fov_V, n_obs = composed
    mesh = make_mesh((2, 2, 2), jax.devices()[:8])
    state0 = make_state(atm, [])
    oe = make_sharded_oe(
        mesh, atm, dl, nu, ["CO2"], MARS, h_fine, state_template=state0,
        fov_V=fov_V, nlte=nlte, cia=cia, n_sub=2, variant="humlicek4",
        cutoff_cm1=8.0, chunk=128, engine="pallas", interpret=True,
        nu_halo=True)
    x0, _ = flatten_state(state0)
    return oe, x0


def test_composed_forward_and_jacobian_parity(composed):
    """Sharded composed forward/Jacobian == dense single-device (f64)."""
    fwd_flat, jac, x0, _ = _single(composed)
    oe, x0s = _sharded(composed)
    y_ref = np.asarray(fwd_flat(x0), np.float64)
    y_sh = np.asarray(oe.forward_flat(x0), np.float64)
    assert np.isfinite(y_ref).all() and (y_ref > 0).any()
    # The kernel is f32 and the line axis is SUMMED in shard order
    # (psum + nu-halo), so parity carries f32 reduction-order noise.
    np.testing.assert_allclose(y_sh, y_ref, rtol=5e-6,
                               atol=y_ref.max() * 1e-8)
    K_ref = np.asarray(jac(x0), np.float64)
    K_sh = np.asarray(oe.jacobian(jnp.asarray(x0)))
    np.testing.assert_allclose(K_sh, K_ref, rtol=1e-5,
                               atol=np.abs(K_ref).max() * 1e-5)


def test_composed_features_are_live(composed):
    """Non-vacuity: each composed feature visibly changes the spectrum
    (a composition test that silently dropped a feature must fail)."""
    atm, dl, nlte, cia, nu, h_fine, fov_V, n_obs = composed
    state0 = make_state(atm, [])
    x0, unravel = flatten_state(state0)

    def build(**over):
        kw = dict(tangent_heights_m=h_fine, fov_V=fov_V, nlte=nlte,
                  cia=cia, n_sub=2, variant="humlicek4", cutoff_cm1=8.0,
                  chunk=128)
        kw.update(over)
        f = build_forward(atm, dl, nu, ["CO2"], MARS, **kw)
        return np.asarray(jax.jit(lambda x: f(unravel(x)))(x0))

    base = build()
    assert np.max(np.abs(build(nlte=None) - base)) > 1e-6 * base.max()
    assert np.max(np.abs(build(cia=None) - base)) > 1e-6 * base.max()
    no_fov = build(fov_V=None)
    assert no_fov.shape != base.shape        # FOV changes the ray axis


def test_composed_retrieval_converges_with_parity(composed):
    """The composed sharded LM retrieval converges and lands on the
    single-device solution (same observations, same start)."""
    atm, dl, nlte, cia, nu, h_fine, fov_V, n_obs = composed
    fwd_flat, jac, x_true, _ = _single(composed)
    oe, _ = _sharded(composed)

    y_clean = np.asarray(fwd_flat(x_true), np.float64)
    sigma = np.full(y_clean.shape, 0.005 * y_clean.max())
    rng = np.random.default_rng(1)
    y_obs = y_clean + sigma * rng.standard_normal(y_clean.shape)
    n_lev = atm.n_lev
    x0 = np.asarray(x_true, np.float64).copy()
    x0[:n_lev] += 4.0
    S_a = np.diag(np.full(n_lev, 10.0 ** 2))

    oe.bind_observation(y_obs, sigma)
    res_sh = retrieve(oe.forward_flat, oe.jacobian, jnp.asarray(y_obs),
                      jnp.asarray(x0), jnp.asarray(x0), S_a,
                      jnp.asarray(sigma), OEConfig(max_iter=8),
                      normal_eqs=oe.normal_eqs)
    assert res_sh.converged, res_sh.history
    res_ref = retrieve(fwd_flat, jac, jnp.asarray(y_obs), jnp.asarray(x0),
                       jnp.asarray(x0), S_a, jnp.asarray(sigma),
                       OEConfig(max_iter=8))
    assert res_ref.converged
    np.testing.assert_allclose(res_sh.x, res_ref.x, rtol=1e-6, atol=1e-5)
    # The 4.3 um prescribed-t_vib scene carries WEAK kinetic-T
    # information (the round-4 ill-posedness note) — the load-bearing
    # assertions above are convergence + sharded-vs-single parity; here we
    # only require a genuine pull toward truth, not full recovery.
    err0 = np.abs(x0[:n_lev] - np.asarray(x_true)[:n_lev]).mean()
    err = np.abs(res_sh.x[:n_lev] - np.asarray(x_true)[:n_lev]).mean()
    assert err < err0 - 0.5, (err0, err)
