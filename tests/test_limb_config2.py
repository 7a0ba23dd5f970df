"""Acceptance config 2 (BASELINE.json:8): multi-layer Mars LTE limb radiance,
full Voigt line-by-line, batch of tangent heights — vs the independent
oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from golden import numpy_ref
from spectrobot_tpu.data import tips
from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.strengths import device_lines_from_linelist

SPECIES_PAIRS = [(2, 1)]
SPECIES_NAMES = ["CO2"]


def _scene():
    atm = mars_standard_atmosphere(n_lev=21, z_top=80e3)
    ll = co2_15um_band(j_max=20)
    dl = device_lines_from_linelist(ll, SPECIES_PAIRS, dtype=jnp.float64)
    nu = np.linspace(655.0, 680.0, 1001)
    h_t = np.array([10e3, 30e3, 50e3])
    return atm, ll, dl, nu, h_t


_jit_limb = jax.jit(limb_radiance,
                    static_argnames=("variant", "cutoff_cm1", "chunk"))


def test_config2_matches_oracle():
    atm, ll, dl, nu, h_t = _scene()
    cg = limb_path_cg(atm, SPECIES_NAMES, jnp.asarray(h_t), MARS, n_sub=4)
    got = np.asarray(_jit_limb(jnp.asarray(nu), dl, cg,
                               variant="weideman", cutoff_cm1=25.0))

    def q_ratio_fn(name, T):
        qr = tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, T)
        return np.full(len(ll), qr)

    for r, ht in enumerate(h_t):
        ref = numpy_ref.limb_radiance(
            nu, {"CO2": ll}, np.asarray(atm.z), np.asarray(atm.p),
            np.asarray(atm.T), np.asarray(atm.n),
            {k: np.asarray(v) for k, v in atm.vmr.items()},
            MARS.radius_m, ht, SPECIES_NAMES, q_ratio_fn, cutoff=25.0, n_sub=4)
        scale = ref.max()
        np.testing.assert_allclose(got[r], ref, rtol=2e-4,
                                   atol=scale * 1e-7, err_msg=f"ray {r}")


def test_config2_physical_behaviour():
    atm, ll, dl, nu, _ = _scene()
    h_t = jnp.asarray([5e3, 20e3, 40e3, 60e3])
    cg = limb_path_cg(atm, SPECIES_NAMES, h_t, MARS)
    got = np.asarray(_jit_limb(jnp.asarray(nu), dl, cg))
    # Radiance decreases with tangent height (thinner, colder paths) in the
    # band core region.
    core = np.abs(nu - 667.4) < 3.0
    means = got[:, core].mean(axis=1)
    assert np.all(np.diff(means) < 0), means
    # Limb radiance is bounded by the warmest layer Planck function.
    b_max = numpy_ref.planck(nu, float(np.asarray(atm.T).max()))
    assert np.all(got <= b_max[None, :] * (1 + 1e-9))


def test_config2_twenty_tangent_heights():
    # The literal config-2 geometry: 20 tangent heights in one batch.
    atm = mars_standard_atmosphere(n_lev=21, z_top=90e3)
    ll = co2_15um_band(j_max=15)
    dl = device_lines_from_linelist(ll, SPECIES_PAIRS, dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(660.0, 675.0, 600))
    h_t = jnp.asarray(np.linspace(5e3, 85e3, 20))
    cg = limb_path_cg(atm, SPECIES_NAMES, h_t, MARS, n_sub=2)
    I = np.asarray(_jit_limb(nu, dl, cg))
    assert I.shape == (20, 600)
    assert np.isfinite(I).all() and (I >= 0).all()
    # Radiance in the band core decreases with height above the peak of the
    # weighting functions; top rays are nearly empty.
    core = np.abs(np.asarray(nu) - 667.4) < 2.0
    means = I[:, core].mean(axis=1)
    assert means[0] > 10 * means[-1]
    assert np.all(np.diff(means[5:]) < 0)


def test_xla_engine_chunk_clamp():
    """The memory clamp that keeps the XLA engine's vmapped Voigt slab
    bounded (a 780-state x 16k-point scene at chunk=128 faulted a device in
    round 4); no-op for ordinary scenes."""
    from spectrobot_tpu.forward.limb import _clamp_chunk

    # Ordinary test scene: untouched.
    assert _clamp_chunk(256, 2 * 6, 256) == 256
    # The faulting scene: 20 rays x 39 layers x 16384 points.
    c = _clamp_chunk(128, 20 * 39, 16384)
    assert 8 <= c < 128
    assert 780 * c * 16384 * 4 <= 5.0e8 or c == 8
    # Floor engages for absurd sizes.
    assert _clamp_chunk(128, 10_000, 1_000_000) == 8
