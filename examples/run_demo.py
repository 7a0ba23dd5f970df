#!/usr/bin/env python
"""Library-API walkthrough: forward limb spectra + a closed-loop retrieval.

This is the script-level workflow the reference drives with ``spect_robot.py``
(SURVEY.md 4.1/4.2), expressed through the framework API.  Run:

    python examples/run_demo.py            # CPU or GPU
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.cli import enable_compile_cache  # noqa: E402

enable_compile_cache()

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu.retrieval.state import build_forward, flatten_state, make_state
from spectrobot_tpu.utils.plots import plot_radiances, plot_retrieval

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out_demo")
os.makedirs(OUT, exist_ok=True)
# float32 on an accelerator, float64 on the CPU.
dtype = jnp.float64 if jax.devices()[0].platform == "cpu" else jnp.float32

# --- scene: Mars CO2 15 um limb scan ---------------------------------------
atm = mars_standard_atmosphere(n_lev=15, z_top=80e3)
atm = jax.tree_util.tree_map(
    lambda a: a.astype(dtype) if hasattr(a, "dtype") else a, atm)
lines = device_lines_from_linelist(co2_15um_band(j_max=30), [(2, 1)],
                                   dtype=dtype)
nu_host = np.linspace(655.0, 680.0, 2048)
nu = jnp.asarray(nu_host, dtype)
nu_off = jnp.asarray(nu_host - float(lines.nu_ref), dtype)
h_t = jnp.asarray(np.linspace(6e3, 70e3, 8), dtype)

# --- forward ---------------------------------------------------------------
cg = limb_path_cg(atm, ["CO2"], h_t, MARS)
I = jax.jit(lambda: limb_radiance(nu, lines, cg, nu_off=nu_off))()
print(f"forward radiances: {I.shape}, peak {float(I.max()):.3e} W/m2/sr/cm-1")
plot_radiances(os.path.join(OUT, "limb_radiances.png"), nu_host,
               np.asarray(I), labels=[f"{h/1e3:.0f} km" for h in np.asarray(h_t)])

# --- the Spectrum family (the reference's SpectralObject currency) ---------
# Wrap the raw array once; units, conversions, band integrals, persistence
# and ILS convolution ride along (spectrobot_tpu/spectra.py).
from spectrobot_tpu.spectra import radiance as radiance_spectrum

sp = radiance_spectrum(nu_host, np.asarray(I))
tb = sp.brightness_temperature()
band = np.asarray(sp.integrate())
print(f"Spectrum: {sp} [{sp.units}]; lowest-ray T_B peak "
      f"{float(np.asarray(tb.values)[0].max()):.1f} K; band radiance "
      f"{band[0]:.3e} W/m2/sr")
sp.save_npz(os.path.join(OUT, "limb_spectrum.npz"),
            tangent_heights_km=np.asarray(h_t) / 1e3)

# --- closed-loop retrieval -------------------------------------------------
W = jnp.asarray(ils_matrix(nu_host, np.linspace(657, 678, 64), 0.5), dtype)
fwd = build_forward(atm, lines, nu, ["CO2"], MARS, tangent_heights_m=h_t,
                    ils_W=W, n_sub=2, nu_off=nu_off)
x_true, unravel = flatten_state(make_state(atm, []))
fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
y_clean = np.asarray(fwd_flat(x_true))
noise = 0.004 * y_clean.max()
rng = np.random.default_rng(0)
y_obs = y_clean + noise * rng.standard_normal(y_clean.shape)

# Start biased by +7 K:
x0 = x_true + 7.0
jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
res = retrieve(fwd_flat, jac, jnp.asarray(y_obs), jnp.asarray(x0),
               jnp.asarray(x0), np.diag(np.full(x0.shape[0], 10.0 ** 2)),
               jnp.full(y_obs.shape, noise), OEConfig(max_iter=10))
errs = np.abs(res.x - np.asarray(x_true))
print(f"retrieval: converged={res.converged} iters={res.n_iter} "
      f"chi2/n={res.chi2_meas / len(y_obs):.2f} dof={res.dof:.1f} "
      f"mean|dT|={errs.mean():.2f} K (started at 7 K)")
plot_retrieval(os.path.join(OUT, "retrieved_T.png"), np.asarray(atm.z),
               res.x, np.asarray(x0),
               T_sigma=np.sqrt(np.diag(res.S_hat)),
               T_true=np.asarray(x_true))
print(f"figures in {OUT}/")
