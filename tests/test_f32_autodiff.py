"""float32 autodiff safety of the full pipeline (regression tests).

Two real failure modes were found running the retrieval step in f32 on an accelerator
(the production dtype): division JVPs SQUARE the divisor, so
(a) tiny tangent-bearing denominators underflow (k_B*T ~ 3e-21 -> 9e-42 -> 0)
(b) huge ones overflow (columns ~1e25 /m^2 -> 1e50 -> inf; inf/inf = NaN).
These tests pin the fixes in atmosphere.with_temperature and
geometry._cg_from_samples (power-of-two pre-scaling + where-guarded divides).
"""

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


def _f32_atm(n_lev=7):
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=60e3)
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, atm)


def test_density_jvp_f32_no_underflow():
    atm = _f32_atm()
    x0 = atm.T

    def n_of_T(T):
        return atm.with_temperature(T).n

    _, t = jax.jvp(n_of_T, (x0,), (jnp.ones_like(x0),))
    a = np.asarray(t)
    assert np.isfinite(a).all()
    assert np.all(a < 0)  # dn/dT < 0 at fixed p


def test_cg_jvp_f32_finite_including_empty_layers():
    atm = _f32_atm()
    h_t = jnp.asarray([6e3, 14e3, 35e3], jnp.float32)  # empty layers exist
    x0 = atm.T

    def cg_of_T(T):
        return limb_path_cg(atm.with_temperature(T), ["CO2", "CO"], h_t,
                            MARS, n_sub=2)[:5]

    _, t = jax.jvp(cg_of_T, (x0,), (jnp.ones_like(x0),))
    for leaf in jax.tree_util.tree_leaves(t):
        assert np.isfinite(np.asarray(leaf)).all()


def test_full_limb_jvp_and_vjp_f32_finite():
    atm = _f32_atm()
    dl = device_lines_from_linelist(co2_15um_band(j_max=8), [(2, 1)],
                                    dtype=jnp.float32)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 128), jnp.float32)
    h_t = jnp.asarray([6e3, 25e3], jnp.float32)
    x0 = atm.T

    def model(T):
        cg = limb_path_cg(atm.with_temperature(T), ["CO2"], h_t, MARS,
                          n_sub=2)
        return limb_radiance(nu, dl, cg, chunk=128)

    _, t = jax.jvp(model, (x0,), (jnp.ones_like(x0),))
    assert np.isfinite(np.asarray(t)).all()

    def model_ad(T):
        cg = limb_path_cg(atm.with_temperature(T), ["CO2"], h_t, MARS,
                          n_sub=2)
        return limb_radiance(nu, dl, cg, chunk=128, analytic_jvp=False)

    g = jax.grad(lambda T: jnp.sum(model_ad(T)))(x0)
    assert np.isfinite(np.asarray(g)).all()
    assert np.any(np.asarray(g) != 0)
