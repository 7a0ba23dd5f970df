#!/usr/bin/env python
"""Tile-size sweep of the Triton opacity kernels on one GPU.

Times the primal line sum and the fused Jacobian basis (66 coefficient
rows: primal + a 32-column Jacobian of two spectra) at the bench scene of
``bench.py`` — 2048 random lines, 8192 points, a 20-ray x 32-level Mars
limb — for each (TILE_P, BLOCK_L, num_warps, num_stages[, row chunk])
given, after a parity check of a few states against the jnp basis.  The best
configuration becomes the constants at the top of
``spectrobot_tpu/ops/pallas_opacity.py``.

    python benchmarks/kernel_sweep.py                 # default grid
    python benchmarks/kernel_sweep.py 64x32x4x1 128x32x8x2x32

Needs a GPU; exits non-zero on any other backend.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _time(fn, *args, n_rep=5):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_scene(seed=0, n_lines=2048, n_points=8192, n_lev=33, n_rays=20):
    """Kernel inputs of the bench scene: (nu_off, nu0, nu_c, sx, y, amps)."""
    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.forward.geometry import limb_path_cg
    from spectrobot_tpu.forward.limb import _tau_prologue
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    ll = random_lines(n_lines, 600.0, 750.0, seed=seed)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3)
    nu64 = np.linspace(600.0, 750.0, n_points)
    nu_off = jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32)
    ths = jnp.asarray(np.linspace(5e3, 70e3, n_rays), jnp.float32)
    cg = limb_path_cg(atm, ["CO2"], ths, MARS, 4)
    nu_c, sx, y, amps, _ = _tau_prologue(dl, cg, None)
    return nu_off, np.asarray(dl.nu0), nu_c, sx, y, amps


def jnp_basis_reference(nu, nu_c, sx, y, coeffs, cutoff):
    """sum_k C_k @ basis_k for each state, from the jnp basis (float32)."""
    from spectrobot_tpu.ops.opacity import _basis

    def one(nc, s, yy, *C):
        basis = _basis(nu, nc, s, yy, variant="humlicek4", cutoff_cm1=cutoff,
                       dt=jnp.float32)
        return sum(jnp.einsum("rl,lp->rp", c, b,
                              precision=jax.lax.Precision.HIGHEST)
                   for c, b in zip(C, basis))
    return jax.jit(jax.vmap(one))(nu_c, sx, y, *coeffs)


def main(argv):
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"kernel_sweep needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    import spectrobot_tpu.ops.pallas_opacity as po

    print(f"device: {dev.device_kind} x{len(jax.devices())}", file=sys.stderr)
    configs = [tuple(int(v) for v in a.split("x")) for a in argv] or [
        (64, 32, 4, 1), (64, 32, 4, 2), (32, 32, 4, 1), (64, 16, 4, 1),
        (64, 32, 4, 1, 32), (64, 32, 8, 1), (64, 32, 2, 1), (32, 16, 2, 1)]
    cutoff = 25.0
    nu, nu0, nu_c, sx, y, amps = bench_scene()
    B, L = nu_c.shape
    key = jax.random.PRNGKey(0)
    R = 66
    coeffs = tuple(
        jax.random.normal(k, (B, R, L), jnp.float32) * amps[:, :1, :]
        for k in jax.random.split(key, 4))
    # Parity on a few live states (the reference holds [L, P] slabs).
    live = np.nonzero(np.asarray(jnp.any(amps != 0, axis=(1, 2))))[0][:4]
    sub = lambda a: a[live]
    ref = np.asarray(jnp_basis_reference(
        nu, sub(nu_c), sub(sx), sub(y), tuple(sub(c) for c in coeffs),
        cutoff))
    for tp, bl, warps, stages, *rc in configs:
        po._NUM_WARPS, po._NUM_STAGES = warps, stages
        po._ROW_CHUNK = rc[0] if rc else 16
        jax.clear_caches()
        win = po.static_windows(np.asarray(nu), nu0, tile_p=tp, block_l=bl,
                                cutoff_cm1=cutoff)
        kw = dict(tile_p=tp, block_l=bl, cutoff_cm1=cutoff, windows=win)
        prim = jax.jit(lambda *a: po.accumulate_pallas_batch_jit(*a, **kw))
        basis = jax.jit(
            lambda *a: po.basis_contract_pallas_batch_jit(*a, **kw))
        try:
            got = np.asarray(basis(nu, sub(nu_c), sub(sx), sub(y),
                                   *(sub(c) for c in coeffs)))
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            t_p = _time(prim, nu, nu_c, sx, y, amps)
            t_b = _time(basis, nu, nu_c, sx, y, *coeffs)
        except Exception as e:  # a config the compiler refuses
            print(f"{tp}x{bl} warps={warps} stages={stages} rows={rc}: FAILED "
                  f"{type(e).__name__}: {str(e)[:300]}")
            continue
        print(f"{tp}x{bl} warps={warps} stages={stages} rows={rc}: primal "
              f"{t_p * 1e3:.3f} ms  basis(R={R}) {t_b * 1e3:.3f} ms  "
              f"parity {err:.2e}  windowed blocks/tile "
              f"{float(np.mean(win[1])):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
