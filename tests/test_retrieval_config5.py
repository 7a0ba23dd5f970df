"""Acceptance config 5 (BASELINE.json:11): full optimal-estimation retrieval
— multi-species (CO2/CO/H2O) limb scan, LM iterations to convergence.

Synthetic-truth closed loop: generate observations from a known atmosphere,
start the retrieval from a biased state, and require (a) LM convergence,
(b) chi^2/n consistent with the injected noise, (c) the temperature error
shrinking substantially towards truth.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, co_fundamental, h2o_band
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu.retrieval.state import (
    build_forward, flatten_state, jacobian_fwd, make_state,
)
from spectrobot_tpu.utils.checkpoint import Checkpointer
from spectrobot_tpu.utils.runlog import RunLogger

SPECIES_PAIRS = [(2, 1), (5, 1), (1, 1)]
SPECIES_NAMES = ["CO2", "CO", "H2O"]


@pytest.fixture(scope="module")
def scene():
    atm_true = mars_standard_atmosphere(n_lev=7, z_top=60e3)
    # Multi-species line list: CO2 15um + CO fundamental + pseudo-H2O band
    # all mapped into one window for a compact test (the physics doesn't care
    # where the bands sit).
    ll = co2_15um_band(j_max=8)
    co = co_fundamental(j_max=6)
    h2o = h2o_band(nu_band=680.0, j_max=5)
    # Shift the CO band into the test window, keeping its strengths/E''.
    co.nu0[:] = co.nu0 - 2143.27 + 655.0
    ll = ll.concat(co).concat(h2o)
    dl = device_lines_from_linelist(ll, SPECIES_PAIRS, dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(645.0, 690.0, 451))
    chans = np.linspace(648.0, 688.0, 81)
    W = jnp.asarray(ils_matrix(np.asarray(nu), chans, fwhm=0.8))
    h_t = jnp.asarray([6e3, 18e3, 35e3])

    def make_fwd(base_atm):
        fwd = build_forward(base_atm, dl, nu, SPECIES_NAMES, MARS,
                            tangent_heights_m=h_t, ils_W=W, n_sub=2,
                            variant="humlicek4", cutoff_cm1=25.0)
        state0 = make_state(base_atm, ["CO"])
        x0, unravel = flatten_state(state0)
        return jax.jit(lambda x: fwd(unravel(x))), x0

    return atm_true, make_fwd


def test_config5_retrieval_converges(scene, tmp_path):
    atm_true, make_fwd = scene
    rng = np.random.default_rng(7)

    fwd_true, x_true = make_fwd(atm_true)
    y_clean = np.asarray(fwd_true(x_true))
    noise_sigma = np.maximum(0.005 * y_clean.max(), 1e-12)
    noise_sigma = np.full_like(y_clean, noise_sigma)
    y_obs = y_clean + noise_sigma * rng.standard_normal(y_clean.shape)

    # Biased initial/prior state: T +8 K, CO x 3.
    n_lev = atm_true.n_lev
    atm_biased = atm_true.with_temperature(atm_true.T + 8.0).with_vmr(
        "CO", 3.0 * atm_true.vmr["CO"])
    fwd_flat, x0 = make_fwd(atm_biased)
    # NOTE x0 parameterises deviations applied to atm_biased's own profile,
    # so truth in this coordinate system is T_true/ln vmr_true directly:
    # make_fwd builds forward closures over base_atm but the state REPLACES
    # T and ln_vmr, so both runs share coordinates.
    x_truth_flat = np.asarray(x_true)

    n_x = x0.shape[0]
    # Prior: generous on T (10 K), on ln CO (ln 5).
    sa_diag = np.concatenate([
        np.full(n_lev, 10.0 ** 2),       # T levels      (ordering: see below)
        np.full(n_lev, np.log(5.0) ** 2),
    ])
    # ravel_pytree orders dict keys alphabetically: "T" then "ln_vmr".
    S_a = np.diag(sa_diag)

    jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
    logger = RunLogger(str(tmp_path / "lm.jsonl"))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    res = retrieve(fwd_flat, jac, jnp.asarray(y_obs), x0, x0, S_a,
                   jnp.asarray(noise_sigma),
                   OEConfig(max_iter=12, chi2_rel_tol=1e-4), logger=logger,
                   checkpointer=ckpt)

    assert res.converged, res.history
    n_y = y_obs.shape[0]
    assert res.chi2_meas / n_y < 2.0, res.chi2_meas / n_y

    # Temperature error collapses towards truth.
    T_err0 = np.abs(np.asarray(x0)[:n_lev] - x_truth_flat[:n_lev])
    T_err = np.abs(res.x[:n_lev] - x_truth_flat[:n_lev])
    assert T_err.mean() < 0.35 * T_err0.mean(), (T_err0.mean(), T_err.mean())

    # CO bias is corrected where the measurement constrains it (lower levels).
    co_err0 = np.abs(np.asarray(x0)[n_lev:] - x_truth_flat[n_lev:])
    co_err = np.abs(res.x[n_lev:] - x_truth_flat[n_lev:])
    assert co_err.mean() < co_err0.mean()

    # Posterior machinery is sane.
    assert res.S_hat.shape == (n_x, n_x)
    ev = np.linalg.eigvalsh(res.S_hat)
    assert np.all(ev > 0)
    ak_diag = np.diag(res.A_kernel)
    assert ak_diag.min() > -1e-9 and ak_diag.max() <= 1.0 + 1e-9
    # DOFs: the measurement actually constrains several parameters.
    assert res.dof > 2.0
    np.testing.assert_allclose(res.dof, ak_diag.sum(), rtol=1e-12)

    # Checkpoint/resume: the checkpointer recorded accepted iterations, and a
    # fresh retrieve() with the same checkpointer resumes instead of
    # restarting from scratch.
    ck = ckpt.latest()
    assert ck is not None and int(ck["iteration"]) >= 0
    res2 = retrieve(fwd_flat, jac, jnp.asarray(y_obs), x0, x0, S_a,
                    jnp.asarray(noise_sigma),
                    OEConfig(max_iter=12, chi2_rel_tol=1e-4),
                    checkpointer=ckpt)
    assert res2.n_iter <= res.n_iter + 2  # resumed near the end


def test_lm_rejects_bad_steps(scene):
    # With an enormous lambda the step is tiny and chi2 barely moves;
    # with lambda ~ 0 LM becomes Gauss-Newton.  Exercise the lambda ladder:
    atm_true, make_fwd = scene
    fwd_flat, x0 = make_fwd(atm_true)
    y = fwd_flat(x0)  # perfect fit at x0 -> any step is rejected/convergence
    n_x = x0.shape[0]
    S_a = np.eye(n_x)
    jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
    res = retrieve(fwd_flat, jac, y, x0, x0, S_a,
                   jnp.full(y.shape, 1e-6), OEConfig(max_iter=4))
    assert res.converged
    assert res.chi2 < 1e-3


def test_nadir_surface_temperature_retrieval():
    # Nadir closed loop: retrieve T profile AND the surface temperature.
    from spectrobot_tpu.data.synth import co2_15um_band
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    atm = mars_standard_atmosphere(n_lev=6, z_top=50e3)
    dl = device_lines_from_linelist(co2_15um_band(j_max=8), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(650.0, 674.0, 300))
    sec = jnp.asarray([1.0, 1.5])
    T_s_true = 255.0

    def make_fwd(base_atm, ts0):
        fwd = build_forward(base_atm, dl, nu, ["CO2"], MARS, sec_theta=sec,
                            T_surface=None, n_sub=2)
        x0, unravel = flatten_state(make_state(base_atm, [], T_surface=ts0))
        return jax.jit(lambda x: fwd(unravel(x))), x0

    fwd_true, x_true = make_fwd(atm, T_s_true)
    y_clean = np.asarray(fwd_true(x_true))
    noise = 0.003 * y_clean.max()
    rng = np.random.default_rng(3)
    y = y_clean + noise * rng.standard_normal(y_clean.shape)

    # Biased start: T profile +6 K, surface +12 K.
    atm_b = atm.with_temperature(atm.T + 6.0)
    fwd_flat, x0 = make_fwd(atm_b, T_s_true + 12.0)
    n_x = x0.shape[0]
    # ravel order: "T" (6), "T_surface" (1), "ln_vmr" (0)
    S_a = np.diag(np.concatenate([np.full(6, 100.0), [400.0]]))
    jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
    res = retrieve(fwd_flat, jac, jnp.asarray(y), x0, x0, S_a,
                   jnp.full(y.shape, noise), OEConfig(max_iter=10))
    assert res.converged
    # Surface temperature recovered to ~1 K (it is strongly constrained by
    # the window regions).
    T_s_hat = res.x[6]
    assert abs(T_s_hat - T_s_true) < 1.5, T_s_hat


def test_state_check_warns_and_logs(tmp_path):
    """round-1 review weak item 5: an accepted LM step that walks the
    state out of physical range triggers the state_check hook (warning +
    JSONL record) without stopping the loop."""
    import warnings

    import jax.numpy as jnp
    import pytest

    from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
    from spectrobot_tpu.utils.runlog import RunLogger

    # 1-parameter quadratic toy problem: minimum at x = 3, so the first
    # accepted step moves x away from 0 and the check fires.
    def fwd(x):
        return x

    def jac(x):
        return jnp.eye(1)

    def check(x):
        return "left the range" if float(x[0]) > 0.5 else None

    log = tmp_path / "log.jsonl"
    with pytest.warns(UserWarning, match="left the range"):
        res = retrieve(fwd, jac, jnp.asarray([3.0]), jnp.asarray([0.0]),
                       jnp.asarray([0.0]), np.eye(1) * 100.0,
                       jnp.asarray([0.1]), OEConfig(max_iter=6),
                       logger=RunLogger(str(log), echo=False),
                       state_check=check)
    assert res.converged
    recs = [json.loads(l) for l in log.read_text().splitlines()]
    assert any("physics_warning" in r for r in recs)
