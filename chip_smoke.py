#!/usr/bin/env python
"""Smoke test of the main path on NVIDIA GPUs, in one process.

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # phase 5 only: the (ray, line, nu) mesh
                                  # on four GPUs, against one card

Phases:
  1. device: the backend must be a GPU; prints the card, JAX and XLA_FLAGS.
  2. forward at full width: ``forward examples/mars_limb.toml`` through
     ``cli.main`` on the default engine and on the other engine, and two
     rays of a 512-point slice against the float64 NumPy oracle.
  3. retrieval: ``retrieve examples/multispecies_retrieval.toml`` in
     self-test mode, to convergence.
  4. kernel at production width: forward + full analytic Jacobian on the
     Triton and the XLA engine, at the bench scene (2048 random lines,
     8192 points, 20 rays x 33 levels = 640 states) and at mars_limb.toml:
     parity, device times, memory; then the tests marked ``chip``.
  5. (--four) mars_limb.toml forward + a short retrieval on a
     ray x nu-halo mesh and a line x nu mesh, each against the one-card
     result, then ``__graft_entry__.dryrun_multichip(4)``.

Any failed check exits non-zero without printing the result line.  The
last line of stdout is one JSON object: ``{"ok": true, "device":
{"platform", "kind", "count"}}``.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MARS_LIMB = os.path.join(REPO, "examples", "mars_limb.toml")
MULTISPECIES = os.path.join(REPO, "examples", "multispecies_retrieval.toml")

# Tolerances (relative to the largest value compared):
ENGINE_TOL = 1e-5   # Triton vs XLA engine, both float32; summation orders
                    # differ (docs/ACCURACY.md: 7.8e-7 measured before)
ORACLE_TOL = 3e-3   # float32 pipeline vs float64 oracle (docs/ACCURACY.md:
                    # residual float32 pipeline error <= 0.3 %)
MESH_TOL = 1e-5     # mesh vs one card, float32


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


def phase_device(n_cards):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's backend is {devs[0].platform!r} "
          f"({devs[0].device_kind}); chip_smoke.py runs only on NVIDIA GPUs")
    check(len(devs) >= n_cards, f"needs {n_cards} GPUs, found {len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    flags = os.environ.get("XLA_FLAGS", "")
    log(f"jax {jax.__version__}; XLA_FLAGS={flags!r}; "
        f"{len(devs)} x {devs[0].device_kind}")
    return devs


def run_cli(*argv):
    """``cli.main`` in this process; returns its JSON result."""
    from spectrobot_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def forward_radiance(cfg_path, tmp, *overrides):
    import numpy as np

    out = tempfile.mkdtemp(dir=tmp)
    args = ["forward", cfg_path, "-o", f"run.output_dir={out}"]
    for ov in overrides:
        args += ["-o", ov]
    res = run_cli(*args)
    with np.load(res["output"]) as z:
        return res, np.asarray(z["radiance"]), np.asarray(z["nu"])


def rel_diff(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_forward(tmp):
    import numpy as np

    t0 = time.time()
    res, I, chans = forward_radiance(MARS_LIMB, tmp)
    log(f"forward mars_limb.toml: {I.shape} radiances, engine={res['engine']},"
        f" {time.time() - t0:.1f} s with compilation")
    check(np.isfinite(I).all() and (I > 0).all(),
          "forward radiances not finite and positive")
    core = np.abs(chans - 667.4) < 3.0
    means = I[:, core].mean(axis=1)
    check(np.all(np.diff(means) < 0),
          f"core radiance does not decrease with tangent height: {means}")
    other = "false" if res["engine"] == "pallas" else "true"
    res2, I2, _ = forward_radiance(MARS_LIMB, tmp,
                                   f"compute.use_pallas={other}")
    d = rel_diff(I, I2)
    log(f"engine parity {res['engine']} vs {res2['engine']}: max rel diff "
        f"{d:.3e} (tolerance {ENGINE_TOL:g})")
    check(res2["engine"] != res["engine"], "the other engine did not run")
    check(d < ENGINE_TOL, "engine parity")
    phase_oracle()


def phase_oracle():
    """Two rays of a 512-point slice of mars_limb.toml on the default
    engine, against the float64 NumPy/scipy oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from golden import numpy_ref
    from spectrobot_tpu import cli
    from spectrobot_tpu.config import load_config
    from spectrobot_tpu.data import tips
    from spectrobot_tpu.forward.geometry import limb_path_cg
    from spectrobot_tpu.forward.limb import limb_radiance

    cfg = load_config(MARS_LIMB, {"grid.nu_min": "660.0",
                                  "grid.nu_max": "675.0",
                                  "grid.n_points": "512"})
    planet, atm, dl, species, nu, nu_off, *_ = cli.build_scene(cfg)
    ll = cli._build_lines(cfg)
    check(set(zip(ll.mol_id.tolist(), ll.iso_id.tolist())) == {(2, 1)},
          "oracle comparison expects one CO2 isotopologue")
    h_t = np.array([20e3, 50e3])
    engine = cli._engine(cfg, dl.n_lines)
    cg = limb_path_cg(atm, species, jnp.asarray(h_t, nu.dtype), planet,
                      cfg.geometry.n_sub)
    got = np.asarray(jax.jit(lambda: limb_radiance(
        nu, dl, cg, cutoff_cm1=cfg.compute.cutoff_cm1, nu_off=nu_off,
        engine=engine))())

    def q_ratio_fn(name, T):
        return np.full(len(ll.nu0), tips.q_of_T(2, 1, 296.0)
                       / tips.q_of_T(2, 1, T))

    worst = 0.0
    for r, ht in enumerate(h_t):
        ref = numpy_ref.limb_radiance(
            np.asarray(nu, np.float64), {"CO2": ll}, np.asarray(atm.z),
            np.asarray(atm.p), np.asarray(atm.T), np.asarray(atm.n),
            {k: np.asarray(v) for k, v in atm.vmr.items()}, planet.radius_m,
            ht, species, q_ratio_fn, cutoff=cfg.compute.cutoff_cm1,
            n_sub=cfg.geometry.n_sub)
        worst = max(worst, rel_diff(got[r], ref))
    log(f"oracle parity ({engine}, float32 vs float64 NumPy, 2 rays x 512 "
        f"points): max rel diff {worst:.3e} (tolerance {ORACLE_TOL:g})")
    check(worst < ORACLE_TOL, "oracle parity")


def phase_retrieval(tmp):
    import numpy as np

    out = tempfile.mkdtemp(dir=tmp)
    t0 = time.time()
    res = run_cli("retrieve", MULTISPECIES, "-o", f"run.output_dir={out}")
    wall = time.time() - t0
    with open(os.path.join(out, "run.jsonl")) as fh:
        chi2_0 = json.loads(fh.readline())["chi2"]
    with np.load(res["output"]) as z:
        n_y = int(np.asarray(z["y_obs"]).size)
    log(f"retrieve multispecies_retrieval.toml: converged={res['converged']} "
        f"({res['stop_reason']}), {res['n_iter']} iterations, chi2 "
        f"{chi2_0:.4g} -> {res['chi2']:.4g} (n_y = {n_y}), {wall:.1f} s wall "
        f"with compilation")
    check(res["converged"], f"retrieval did not converge: {res['status']}")
    check(res["chi2"] < 2.0 * n_y and res["chi2"] < 0.5 * chi2_0,
          "chi2 did not collapse towards n_y")


def _time(fn, x, n_rep=5):
    import jax
    jax.block_until_ready(fn(x))
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        best = min(best, time.perf_counter() - t0)
    return best


def bench_scene_forward(engine):
    """The bench scene: 2048 random lines (seed 0) on 600-750 cm-1, 8192
    points, 20 rays x 33 levels, ILS to 256 channels; state = T profile."""
    import jax.numpy as jnp
    import numpy as np

    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.ops.ils import ils_matrix
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu.retrieval.state import (
        build_forward, flatten_state, make_state)

    ll = random_lines(2048, 600.0, 750.0, seed=0)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32)
    atm = mars_standard_atmosphere(n_lev=33, z_top=80e3)
    nu64 = np.linspace(600.0, 750.0, 8192)
    nu = jnp.asarray(nu64, jnp.float32)
    nu_off = jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32)
    ths = jnp.asarray(np.linspace(5e3, 70e3, 20), jnp.float32)
    W = jnp.asarray(ils_matrix(nu64, np.linspace(605.0, 745.0, 256), 0.8),
                    jnp.float32)
    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=ths,
                        ils_W=W, nu_off=nu_off, engine=engine)
    x0, unravel = flatten_state(make_state(atm, retrieve_vmr=[]))
    return (lambda x: fwd(unravel(x))), x0


def mars_limb_forward(engine):
    """examples/mars_limb.toml as cmd_retrieve builds it (T profile)."""
    from spectrobot_tpu import cli
    from spectrobot_tpu.config import load_config
    from spectrobot_tpu.retrieval.state import (
        build_forward, flatten_state, make_state)

    cfg = load_config(MARS_LIMB)
    planet, atm, dl, species, nu, nu_off, W, _, nlte, cia = \
        cli.build_scene(cfg)
    h_t, fov_V = cli._build_fov(cfg, nu.dtype)
    fwd = build_forward(atm, dl, nu, species, planet, tangent_heights_m=h_t,
                        ils_W=W, fov_V=fov_V, nlte=nlte,
                        n_sub=cfg.geometry.n_sub,
                        cutoff_cm1=cfg.compute.cutoff_cm1,
                        chunk=cfg.compute.chunk, nu_off=nu_off,
                        engine=engine, cia=cia)
    x0, unravel = flatten_state(make_state(atm, retrieve_vmr=[]))
    return (lambda x: fwd(unravel(x))), x0


def compare_engines(name, build):
    """Forward + full jacfwd Jacobian on both engines: parity, then the
    best of 5 device times (host clock around block_until_ready)."""
    import jax
    import numpy as np

    times, outs = {}, {}
    for engine in ("pallas", "jnp"):
        f, x0 = build(engine)
        fwd, jac = jax.jit(f), jax.jit(jax.jacfwd(f))
        t0 = time.time()
        outs[engine] = (np.asarray(fwd(x0)), np.asarray(jac(x0)))
        t_first = time.time() - t0
        times[engine] = (_time(fwd, x0), _time(jac, x0))
        log(f"{name} [{engine}]: forward {times[engine][0] * 1e3:.2f} ms, "
            f"forward+Jacobian({x0.shape[0]} cols) "
            f"{times[engine][1] * 1e3:.2f} ms; first call with compilation "
            f"{t_first:.1f} s")
        if engine == "pallas":
            mem = jac.lower(x0).compile().memory_analysis()
            log(f"{name} [pallas] fused Jacobian step memory_analysis: "
                f"{mem}")
    (y1, J1), (y2, J2) = outs["pallas"], outs["jnp"]
    check(np.isfinite(y1).all() and np.isfinite(J1).all(),
          f"{name}: non-finite kernel output")
    dy, dJ = rel_diff(y1, y2), rel_diff(J1, J2)
    log(f"{name}: Triton vs XLA parity forward {dy:.3e}, Jacobian {dJ:.3e} "
        f"(tolerance {ENGINE_TOL:g}); time ratio XLA/Triton forward "
        f"{times['jnp'][0] / times['pallas'][0]:.2f}x, Jacobian "
        f"{times['jnp'][1] / times['pallas'][1]:.2f}x")
    check(dy < ENGINE_TOL and dJ < ENGINE_TOL, f"{name}: engine parity")


def phase_kernel():
    import pytest

    compare_engines("bench scene (2048 lines, 8192 pts, 640 states)",
                    bench_scene_forward)
    compare_engines("mars_limb.toml", mars_limb_forward)
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "--chip", "-m", "chip",
                      os.path.join(REPO, "tests", "test_chip.py")])
    check(rc == 0, f"chip tests failed (pytest exit code {rc})")


def phase_four(tmp):
    """The (ray, line, nu) mesh on four cards against one card."""
    import numpy as np

    import __graft_entry__

    _, I1, _ = forward_radiance(MARS_LIMB, tmp)
    meshes = {"ray2 x nu2 halo": ("compute.mesh_ray=2", "compute.mesh_nu=2",
                                  "compute.mesh_halo=true"),
              "line2 x nu2 psum": ("compute.mesh_line=2", "compute.mesh_nu=2")}
    short = ("retrieval.max_iter=2",)
    r1 = _retrieve_state(tmp, short)
    for name, ovs in meshes.items():
        _, I, _ = forward_radiance(MARS_LIMB, tmp, *ovs)
        d = rel_diff(I, I1)
        log(f"mesh {name}: forward vs one card max rel diff {d:.3e} "
            f"(tolerance {MESH_TOL:g})")
        check(d < MESH_TOL, f"mesh {name} forward parity")
        r = _retrieve_state(tmp, short + ovs)
        dx = float(np.abs(r["x"] - r1["x"]).max())
        dchi = abs(r["chi2"] - r1["chi2"]) / r1["chi2"]
        log(f"mesh {name}: 2-iteration retrieval vs one card: max |dx| "
            f"{dx:.3e} K, chi2 {r['chi2']:.6g} vs {r1['chi2']:.6g}")
        check(dx < 1e-2 and dchi < 1e-3, f"mesh {name} retrieval parity")
    __graft_entry__.dryrun_multichip(4)


def _retrieve_state(tmp, overrides):
    import numpy as np

    out = tempfile.mkdtemp(dir=tmp)
    args = ["retrieve", MARS_LIMB, "-o", f"run.output_dir={out}"]
    for ov in overrides:
        args += ["-o", ov]
    res = run_cli(*args)
    with np.load(res["output"]) as z:
        return {"x": np.asarray(z["x"]), "chi2": float(res["chi2"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    try:
        devs = phase_device(n_cards)
        sys.path.insert(0, REPO)
        with tempfile.TemporaryDirectory() as tmp:
            if args.four:
                phase_four(tmp)
            else:
                phase_forward(tmp)
                phase_retrieval(tmp)
                phase_kernel()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
