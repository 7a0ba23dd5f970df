#!/usr/bin/env python
"""Headline benchmarks on one GPU (BASELINE.json:2 — both metrics, plus the
production-engine scenes).

1. Limb scan: Mars limb forward model (20 tangent heights, 8192 spectral
   points, 32 levels, ILS) + full analytic Jacobian over the 32-parameter
   temperature profile, on the production engine (ops.opacity.
   default_engine: the Triton kernels on a GPU).
2. Fused engine: the same scene at 2048 lines with engine='pallas' —
   forward + fused in-kernel {K, Kx, xKx, Ky} analytic Jacobian.
3. Sharded forward: the shard_map mesh path with the kernel inside the
   body, on a (1, 1, n_devices) mesh, against the plain single-device
   forward (vs_baseline = plain / mesh time; 1.0 = no mesh overhead).
4. Kernel throughput: (spectral-point x line) evaluations per second,
   dense evaluation (every pair evaluated, no cutoff) on the Triton line
   sum.  vs_baseline divides by the project target of 1e9 evals/s per
   device (BASELINE.md; a target, not a measurement).

Times are the best of ``N_REP`` calls after a warm-up call, on the host
clock around ``block_until_ready``.  Prints one JSON line per metric, each
naming its device; the kernel-throughput metric is the LAST line.  The
device, its count and the ``nvidia-smi`` name and power limit go to
stderr.  Exits non-zero unless JAX's backend is a GPU: numbers from any
other backend are not device metrics.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.cli import enable_compile_cache

BASELINE = 1.0e9  # evals/s/device target (BASELINE.md)
N_REP = 5


def best_time(fn, *args) -> float:
    """Best of N_REP wall times of ``fn(*args)`` after one warm-up call."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(N_REP):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def emit(metric: str, value: float, unit: str, vs_baseline=None) -> None:
    rec = {"metric": metric, "value": value, "unit": unit,
           "device": _device()}
    if vs_baseline is not None:
        rec["vs_baseline"] = vs_baseline
    print(json.dumps(rec), flush=True)


def _limb_scene(L=None, n_lev=32, n_rays=20, P=8192):
    """Mars limb scene: the CO2 15 um band (L=None) or L random lines."""
    from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
    from spectrobot_tpu.data.synth import co2_15um_band, random_lines
    from spectrobot_tpu.ops.ils import ils_matrix
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    ll = (co2_15um_band(j_max=80) if L is None
          else random_lines(L, 600.0, 750.0, seed=3))
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3)
    nu64 = np.linspace(600.0, 750.0, P)
    nu = jnp.asarray(nu64, jnp.float32)
    nu_off = jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32)
    ths = jnp.asarray(np.linspace(5e3, 70e3, n_rays), jnp.float32)
    W = jnp.asarray(ils_matrix(nu64, np.linspace(605.0, 745.0, 256), 0.8),
                    jnp.float32)
    return atm, dl, nu, nu_off, ths, W


def _forward_jacobian(engine, L=None):
    from spectrobot_tpu.data.atmosphere import MARS
    from spectrobot_tpu.retrieval.state import (
        build_forward, flatten_state, jacobian_fwd_chunked, make_state)

    atm, dl, nu, nu_off, ths, W = _limb_scene(L)
    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=ths,
                        ils_W=W, nu_off=nu_off, engine=engine)
    x0, unravel = flatten_state(make_state(atm, retrieve_vmr=[]))
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    jac = jax.jit(lambda x: jacobian_fwd_chunked(
        lambda v: fwd(unravel(v)), x, chunk=32))
    t0 = time.time()
    jax.block_until_ready((fwd_flat(x0), jac(x0)))
    print(f"compile+first run: {time.time() - t0:.1f}s ({dl.n_lines} lines,"
          f" engine={engine})", file=sys.stderr)
    t_fwd, t_jac = best_time(fwd_flat, x0), best_time(jac, x0)
    print(f"forward {t_fwd * 1e3:.2f} ms  jacobian {t_jac * 1e3:.2f} ms",
          file=sys.stderr)
    return t_fwd, t_jac, dl.n_lines


def bench_limb_scan() -> None:
    from spectrobot_tpu.ops.opacity import default_engine

    engine = default_engine()
    t_fwd, t_jac, L = _forward_jacobian(engine)
    emit("limb_scan_forward_jacobian_wall_s", t_fwd + t_jac,
         f"s (forward + 32-column analytic Jacobian, {L} lines, {engine})")


def bench_fused_pallas() -> None:
    t_fwd, t_jac, L = _forward_jacobian("pallas", L=2048)
    emit("fused_pallas_forward_jacobian_wall_s", t_fwd + t_jac,
         f"s (forward + 32-column fused-basis Jacobian, {L} lines, pallas)")


def bench_sharded_pallas() -> None:
    from spectrobot_tpu.data.atmosphere import MARS
    from spectrobot_tpu.forward.geometry import limb_path_cg
    from spectrobot_tpu.forward.limb import limb_radiance
    from spectrobot_tpu.parallel.mesh import make_mesh
    from spectrobot_tpu.parallel.sharded import (
        pad_lines_for_mesh, sharded_radiance_fn, stage_sharded)

    atm, dl, nu, nu_off, ths, _ = _limb_scene(L=2048)
    cg = limb_path_cg(atm, ["CO2"], ths, MARS, 4)
    n_dev = len(jax.devices())
    mesh = make_mesh((1, 1, n_dev))
    f = sharded_radiance_fn(mesh, has_nlte=False, has_background=False,
                            engine="pallas", win_grid=np.asarray(nu_off),
                            win_lines=np.asarray(dl.nu0))
    nu_s, lines_s, cg_s, _, _ = stage_sharded(
        mesh, nu, pad_lines_for_mesh(dl, 1), cg)
    mesh_fn = jax.jit(lambda c: f(nu_s, lines_s, c, nu_off=nu_off))
    single_fn = jax.jit(lambda c: limb_radiance(nu, dl, c, nu_off=nu_off,
                                                engine="pallas"))
    t_mesh, t_single = best_time(mesh_fn, cg_s), best_time(single_fn, cg)
    print(f"sharded forward {t_mesh * 1e3:.2f} ms on a (1, 1, {n_dev}) mesh "
          f"vs {t_single * 1e3:.2f} ms plain", file=sys.stderr)
    emit("sharded_pallas_forward_wall_s", t_mesh,
         f"s (shard_map + pallas engine, 2048 lines, {n_dev} devices)",
         vs_baseline=t_single / t_mesh)


def bench_kernel() -> None:
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.ops.opacity import line_kernel_inputs
    from spectrobot_tpu.ops.pallas_opacity import accumulate_pallas
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    P, L = 16384, 20480
    ll = random_lines(L, 600.0, 740.0, seed=0)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                            amp_weights=jnp.ones((2, dl.n_lines), jnp.float32))
    nu = jnp.asarray(np.linspace(640.0, 700.0, P), jnp.float32)
    run = jax.jit(lambda a: accumulate_pallas(nu, kl._replace(amps=a),
                                              cutoff_cm1=None))
    dt = best_time(run, kl.amps)
    print(f"dense kernel {dt * 1e3:.3f} ms for {P}x{L} pairs",
          file=sys.stderr)
    emit("voigt_opacity_dense_evals_per_s_per_chip", P * L / dt,
         "(spectral-point x line)/s", vs_baseline=P * L / dt / BASELINE)


def main() -> int:
    dev = _device()
    if dev["platform"] != "gpu":
        print(f"bench.py measures a GPU; JAX's backend is {dev['platform']}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {dev['kind']} x{dev['count']} ({dev['platform']}); "
          f"nvidia-smi: {smi.stdout.strip()}", file=sys.stderr)
    bench_limb_scan()
    bench_fused_pallas()
    bench_sharded_pallas()
    bench_kernel()    # headline metric LAST
    return 0


if __name__ == "__main__":
    sys.exit(main())
