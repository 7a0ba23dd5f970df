#!/usr/bin/env python
"""Device-time trace summary: a profiling workflow packaged for reuse.

Captures a ``jax.profiler`` trace of the production fused
forward+Jacobian scenario (or ``--scenario forward``) and prints device
time aggregated by op family: the Triton kernels, fusions, and — the
smells worth hunting — ``while`` + ``dynamic-update-slice`` pairs, which
is how middle-axis gathers and ``cumsum`` show up when XLA serialises them
(each such loop walks the full spectral slab one segment at a time).

Run on a GPU:  python benchmarks/trace_summary.py [--scenario jac|forward]
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scenario(name: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.ops.ils import ils_matrix
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu.retrieval.state import (
        build_forward, flatten_state, jacobian_fwd_chunked, make_state)

    P, n_lev, n_rays, L = 8192, 32, 20, 2048
    ll = random_lines(L, 600.0, 750.0, seed=3)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3)
    nu64 = np.linspace(600.0, 750.0, P)
    nu = jnp.asarray(nu64, jnp.float32)
    nu_off = jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32)
    ths = jnp.asarray(np.linspace(5e3, 70e3, n_rays), jnp.float32)
    W = jnp.asarray(ils_matrix(nu64, np.linspace(605.0, 745.0, 256), 0.8),
                    jnp.float32)
    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, tangent_heights_m=ths,
                        ils_W=W, nu_off=nu_off, engine="pallas")
    x0, unravel = flatten_state(make_state(atm, retrieve_vmr=[]))
    fwd_flat = lambda x: fwd(unravel(x))
    if name == "forward":
        return jax.jit(fwd_flat), x0
    return jax.jit(lambda x: jacobian_fwd_chunked(fwd_flat, x, chunk=32)), x0


def summarize(trace_dir: str, n_reps: int) -> list:
    path = glob.glob(os.path.join(trace_dir,
                                  "plugins/profile/*/*.trace.json.gz"))[0]
    d = json.load(gzip.open(path))
    pids = {e["pid"]: e["args"].get("name", "") for e in d["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in d["traceEvents"]:
        if e.get("ph") == "X" and e.get("dur"):
            if "/device:" in pids.get(e["pid"], ""):
                base = re.sub(r"[.\d()]+$", "", e["name"])
                agg[base] += e["dur"]
                cnt[base] += 1
    rows = [(us / n_reps / 1000.0, cnt[name], name)
            for name, us in agg.most_common()
            if not name.startswith("jit_")]
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="jac", choices=["jac", "forward"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    from spectrobot_tpu.cli import enable_compile_cache
    enable_compile_cache()

    fn, x0 = build_scenario(args.scenario)
    jax.block_until_ready(fn(x0))                       # compile
    trace_dir = tempfile.mkdtemp(prefix="sbt_trace_")
    with jax.profiler.trace(trace_dir):
        for _ in range(args.reps):
            jax.block_until_ready(fn(x0))

    rows = summarize(trace_dir, args.reps)
    total = sum(r[0] for r in rows)
    print(f"scenario={args.scenario}  device total/rep: {total:.1f} ms")
    for ms, n, name in rows[:15]:
        flag = "  <-- serialised loop?" if name in (
            "while", "dynamic-update-slice") and ms > 0.05 * total else ""
    # noqa: line kept simple
        print(f"{ms:9.2f} ms  x{n:6d}  {name}{flag}")


if __name__ == "__main__":
    main()
