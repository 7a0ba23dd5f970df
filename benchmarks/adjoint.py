"""Adjoint (reverse-mode) benchmark: analytic custom VJP vs plain AD.

Measures grad of a chi-square-like scalar through the full limb forward —
the gradient-descent / adjoint retrieval economics.  The analytic transpose
(ops.opacity._tangent_transpose) recomputes the Voigt basis in the backward
pass instead of storing AD's per-scan-step linearisation, so it wins on both
memory and time.  Run on a GPU: python benchmarks/adjoint.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


def main(n_points=8192, n_lev=32, j_max=80, n_rays=10):
    ll = co2_15um_band(j_max=j_max)
    print(f"lines={ll.nu0.shape[0]}  points={n_points}  lev={n_lev} "
          f"rays={n_rays}  device={jax.devices()[0].device_kind}")
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3)
    nu64 = np.linspace(600.0, 750.0, n_points)
    nu = jnp.asarray(nu64, jnp.float32)
    nu_off = jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32)
    ths = jnp.asarray(np.linspace(10e3, 70e3, n_rays), jnp.float32)

    def loss(T, mode):
        cg = limb_path_cg(atm.with_temperature(T), ["CO2"], ths, MARS, 2)
        I = limb_radiance(nu, dl, cg, analytic_jvp=mode, nu_off=nu_off)
        return jnp.sum(I * I)

    results = {}
    for name, mode in (("analytic_rev", "rev"), ("plain_ad", False)):
        g = jax.jit(jax.grad(lambda T: loss(T, mode)))
        t0 = time.perf_counter()
        out = jax.block_until_ready(g(atm.T))
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(g(atm.T))
            ts.append(time.perf_counter() - t0)
        results[name] = (np.median(ts), out)
        print(f"{name:14s} grad: {np.median(ts)*1e3:8.1f} ms "
              f"(compile {compile_s:.1f}s)")
    ga, gp = results["analytic_rev"][1], results["plain_ad"][1]
    rel = float(np.max(np.abs(np.asarray(ga) - np.asarray(gp)))
                / np.max(np.abs(np.asarray(gp))))
    print(f"speedup: {results['plain_ad'][0]/results['analytic_rev'][0]:.2f}x"
          f"   max rel grad diff: {rel:.2e}")


if __name__ == "__main__":
    main()
