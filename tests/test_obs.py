"""Observation model (C17): masks/windows, persistence, OE integration."""

import numpy as np

from spectrobot_tpu.retrieval.obs import Observation


def _obs():
    chans = np.linspace(650.0, 690.0, 41)
    y = np.outer([1.0, 0.8, 0.5], np.ones(41))
    return Observation.synthesize(y, chans, noise_sigma=0.01, seed=1,
                                  tangent_heights_m=np.array([10e3, 20e3, 30e3]))


def test_windows_mask_channels():
    obs = _obs()
    assert obs.n_used == 3 * 41
    w = obs.with_windows([(655.0, 660.0), (680.0, 685.0)])
    inside = ((w.nu_channels >= 655) & (w.nu_channels <= 660)) | \
             ((w.nu_channels >= 680) & (w.nu_channels <= 685))
    assert w.n_used == 3 * inside.sum()
    yf, sf = w.flattened()
    assert yf.shape == sf.shape == (3 * 41,)
    # masked channels carry huge sigma -> zero weight
    big = sf.reshape(3, 41)[:, ~inside]
    assert np.all(big > 1e29)
    used = sf.reshape(3, 41)[:, inside]
    np.testing.assert_allclose(used, 0.01)


def test_round_trip(tmp_path):
    obs = _obs().with_windows([(660.0, 670.0)])
    p = str(tmp_path / "obs.npz")
    obs.save_npz(p)
    o2 = Observation.load_npz(p)
    np.testing.assert_allclose(o2.y, obs.y)
    assert o2.n_used == obs.n_used
    np.testing.assert_allclose(o2.tangent_heights_m, obs.tangent_heights_m)


def test_masked_channels_do_not_affect_retrieval_cost():
    # chi2 contribution from masked channels is ~ (dy/1e30)^2 ~ 0.
    obs = _obs().with_windows([(660.0, 670.0)])
    yf, sf = obs.flattened()
    resid = np.ones_like(yf)
    chi2 = np.sum((resid / sf) ** 2)
    chi2_used = np.sum((resid[sf < 1] / sf[sf < 1]) ** 2)
    np.testing.assert_allclose(chi2, chi2_used, rtol=1e-12)
    assert 0 < obs.chi2_per_dof(chi2) == chi2 / obs.n_used


def test_plot_helpers(tmp_path):
    import os
    from spectrobot_tpu.utils.plots import (
        plot_averaging_kernels, plot_radiances, plot_retrieval,
    )
    nu = np.linspace(600, 700, 200)
    I = np.abs(np.random.default_rng(0).standard_normal((3, 200)))
    p1 = plot_radiances(str(tmp_path / "rad.png"), nu, I, labels=["a", "b", "c"])
    z = np.linspace(0, 60e3, 9)
    Tr = 200 + np.random.default_rng(1).standard_normal(9)
    p2 = plot_retrieval(str(tmp_path / "ret.png"), z, Tr, Tr + 5,
                        T_sigma=np.full(9, 2.0), T_true=Tr - 1)
    A = np.eye(9) * 0.8
    p3 = plot_averaging_kernels(str(tmp_path / "ak.png"), z, A, 9)
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 5000


def test_profiling_utils(tmp_path):
    import jax.numpy as jnp
    from spectrobot_tpu.utils.profiling import (
        annotate, stopwatch, trace,
    )
    from spectrobot_tpu.utils.runlog import RunLogger

    with annotate("opacity"):
        x = jnp.ones((8,)) * 2.0
    log = RunLogger(str(tmp_path / "t.jsonl"))
    with stopwatch("stage", sink=log):
        pass
    with trace(str(tmp_path / "trace")):
        jnp.sum(x).block_until_ready()


def test_debug_utils():
    import jax
    import jax.numpy as jnp
    from spectrobot_tpu.utils.debug import assert_finite, checked

    def f(x):
        return jnp.log(x)            # NaN for x < 0

    g = checked(f)
    err, out = g(jnp.asarray([1.0, 2.0]))
    err.throw()                      # clean input -> no raise
    err, out = g(jnp.asarray([-1.0]))
    try:
        err.throw()
        raised = False
    except Exception:
        raised = True
    assert raised

    @jax.jit
    def h(x):
        return assert_finite("h", x) * 2.0

    np.testing.assert_allclose(np.asarray(h(jnp.asarray([1.0, 2.0]))),
                               [2.0, 4.0])


def test_table_round_trip(tmp_path):
    """Text-table ingestion (round-1 review item 8): save_table ->
    load_table -> identical Observation, including ragged masks."""
    rng = np.random.default_rng(0)
    y = rng.uniform(0.01, 0.02, (3, 5))
    sigma = np.full((3, 5), 1e-4)
    mask = np.ones((3, 5), dtype=bool)
    mask[1, 2] = mask[2, 4] = False
    obs = Observation(y=y, sigma=sigma, mask=mask,
                      nu_channels=np.linspace(660.0, 664.0, 5),
                      tangent_heights_m=np.array([8e3, 20e3, 35e3]))
    p = str(tmp_path / "obs.txt")
    obs.save_table(p)
    back = Observation.load_table(p)
    np.testing.assert_allclose(back.y, obs.y, rtol=1e-7)
    np.testing.assert_allclose(back.sigma, obs.sigma, rtol=1e-7)
    np.testing.assert_array_equal(back.mask, obs.mask)
    np.testing.assert_allclose(back.nu_channels, obs.nu_channels, atol=1e-6)
    np.testing.assert_allclose(back.tangent_heights_m, obs.tangent_heights_m,
                               rtol=1e-9)
    # auto-dispatching loader
    back2 = Observation.load(p)
    np.testing.assert_allclose(back2.y, obs.y, rtol=1e-7)


def test_table_ragged_coverage_masks_missing(tmp_path):
    """(ray, channel) combinations absent from the file come back masked."""
    p = tmp_path / "ragged.csv"
    p.write_text(
        "# geometry = limb\n"
        "8.0, 660.0, 1.0e-2, 1e-4\n"
        "8.0, 661.0, 1.1e-2, 1e-4\n"
        "25.0, 661.0, 4.0e-3, 2e-4\n")
    obs = Observation.load_table(str(p))
    assert obs.y.shape == (2, 2)
    assert obs.mask.tolist() == [[True, True], [False, True]]
    y_flat, sig_flat = obs.flattened()
    assert sig_flat[2] > 1e20   # masked channel carries infinite noise


def test_table_nadir_geometry(tmp_path):
    p = tmp_path / "nadir.dat"
    p.write_text("# geometry = nadir\n"
                 "1.0 660.0 1e-2 1e-4 1\n"
                 "1.0 661.0 1e-2 1e-4 0\n")
    obs = Observation.load_table(str(p))
    assert obs.sec_theta is not None and obs.tangent_heights_m is None
    assert obs.mask.tolist() == [[True, False]]


def test_table_rejects_bad_columns(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("8.0 660.0 1e-2\n")
    import pytest
    with pytest.raises(ValueError, match="4 or 5 columns"):
        Observation.load_table(str(p))
