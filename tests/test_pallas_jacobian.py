"""Fused analytic-Jacobian basis kernel (round-1 review item 4).

Covers, on the interpret-mode kernel (CPU):
  * the closed-form Humlicek-w4 gradient vs finite differences of the primal;
  * the region-tier derivative formulas vs the full evaluator;
  * basis-contraction kernel parity vs the jnp basis path (single + batch);
  * end-to-end jacfwd through the limb forward, engine='pallas' vs 'jnp' —
    which exercises BOTH custom_vmap levels (structural ray x layer batches
    and the tangent fold into kernel rows).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.opacity import _tangent_via_basis, line_kernel_inputs
from spectrobot_tpu.ops.pallas_opacity import (
    _wrg_region1, _wrg_region2, _wr_region1, _wr_region2,
    basis_contract_pallas_batch_jit, basis_contract_pallas_jit)
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.ops.voigt import wofz_humlicek4, wofz_humlicek4_grad


def test_w4_grad_matches_fd_of_primal():
    """The closed-form w4 gradient IS the derivative of the w4 primal —
    checked by central differences away from region boundaries."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.uniform(0, 5, 200), rng.uniform(5, 20, 200),
                         10 ** rng.uniform(1.5, 4.5, 200)])
    ys = 10 ** rng.uniform(-4, 1, xs.size)
    s = xs + ys
    ok = (np.abs(s - 5.5) > 0.05) & (np.abs(s - 15) > 0.05) & \
         (np.abs(ys - (0.195 * xs - 0.176)) > 0.02)
    x, y = jnp.asarray(xs[ok]), jnp.asarray(ys[ok])
    wr, wi, kx, ky = wofz_humlicek4_grad(x, y)
    wr0, wi0 = wofz_humlicek4(x, y)
    np.testing.assert_array_equal(np.asarray(wr), np.asarray(wr0))
    np.testing.assert_array_equal(np.asarray(wi), np.asarray(wi0))
    h = 1e-6
    K = lambda x, y: wofz_humlicek4(x, y)[0]
    kx_fd = (K(x + h, y) - K(x - h, y)) / (2 * h)
    ky_fd = (K(x, y + h) - K(x, y - h)) / (2 * h)
    np.testing.assert_allclose(np.asarray(kx), np.asarray(kx_fd),
                               rtol=2e-5, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ky), np.asarray(ky_fd),
                               rtol=2e-5, atol=1e-12)


def test_w4_grad_f32_wing_stable():
    x32 = jnp.asarray(10 ** np.linspace(2, 4.9, 40), jnp.float32)
    y32 = jnp.full_like(x32, 1e-3)
    _, _, kx32, ky32 = wofz_humlicek4_grad(x32, y32)
    _, _, kx64, ky64 = wofz_humlicek4_grad(
        x32.astype(jnp.float64), y32.astype(jnp.float64))
    assert bool(jnp.all(jnp.isfinite(kx32))) and bool(jnp.all(jnp.isfinite(ky32)))
    np.testing.assert_allclose(np.asarray(kx32), np.asarray(kx64), rtol=5e-6)
    np.testing.assert_allclose(np.asarray(ky32), np.asarray(ky64), rtol=5e-6)


def test_region_tier_derivatives():
    """The cheap region-1/2 tier formulas equal FD of their own primal and
    the full grad evaluator inside their validity regions."""
    rng = np.random.default_rng(2)
    x1 = jnp.asarray(rng.uniform(16, 2000, 200))
    y1 = jnp.asarray(rng.uniform(1e-4, 5, 200))
    x2r = rng.uniform(0.0, 8.0, 400)
    y2r = rng.uniform(0.1, 8.0, 400)
    m = (x2r + y2r > 5.6) & (x2r + y2r < 14.9)
    x2, y2 = jnp.asarray(x2r[m]), jnp.asarray(y2r[m])
    h = 1e-7
    for fn, wfn, x, y in [(_wrg_region1, _wr_region1, x1, y1),
                          (_wrg_region2, _wr_region2, x2, y2)]:
        K, kx, ky = fn(x, y)
        np.testing.assert_allclose(np.asarray(K), np.asarray(wfn(x, y)),
                                   rtol=1e-12, atol=1e-300)
        kx_fd = (wfn(x + h, y) - wfn(x - h, y)) / (2 * h)
        ky_fd = (wfn(x, y + h) - wfn(x, y - h)) / (2 * h)
        np.testing.assert_allclose(np.asarray(kx), np.asarray(kx_fd), rtol=2e-5)
        np.testing.assert_allclose(np.asarray(ky), np.asarray(ky_fd), rtol=2e-5)
        _, _, kxh, kyh = wofz_humlicek4_grad(x, y)
        np.testing.assert_array_equal(np.asarray(kx), np.asarray(kxh))
        np.testing.assert_array_equal(np.asarray(ky), np.asarray(kyh))


@pytest.fixture(scope="module")
def tangent_fixture():
    rng = np.random.default_rng(1)
    L, P = 150, 300
    ll = random_lines(L, 600.0, 640.0, seed=0)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32, nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                            amp_weights=jnp.ones((2, dl.n_lines), jnp.float32))
    nu = jnp.asarray(np.linspace(605.0, 635.0, P), jnp.float32)
    dnc = jnp.asarray(rng.normal(size=L) * 1e-3, jnp.float32)
    dsx = jnp.asarray(rng.normal(size=L) * np.asarray(kl.scale_x) * 1e-2,
                      jnp.float32)
    dy = jnp.asarray(rng.normal(size=L) * np.asarray(kl.y) * 1e-2, jnp.float32)
    dam = jnp.asarray(rng.normal(size=(2, L)) * np.asarray(kl.amps) * 1e-2,
                      jnp.float32)
    return nu, kl, dnc, dsx, dy, dam


def _coeffs(kl, dnc, dsx, dy, dam):
    return (dam, kl.amps * (-kl.scale_x * dnc)[None, :],
            kl.amps * (dsx / kl.scale_x)[None, :], kl.amps * dy[None, :])


def test_basis_kernel_matches_jnp_basis(tangent_fixture):
    nu, kl, dnc, dsx, dy, dam = tangent_fixture
    ref = _tangent_via_basis(nu, kl.nu_c, kl.scale_x, kl.y, kl.amps,
                             dnc, dsx, dy, dam, chunk=64,
                             variant="humlicek4", cutoff_cm1=25.0)
    C1, C2, C3, C4 = _coeffs(kl, dnc, dsx, dy, dam)
    out = basis_contract_pallas_jit(nu, kl.nu_c, kl.scale_x, kl.y,
                                    C1, C2, C3, C4, tile_p=128, block_l=128,
                                    cutoff_cm1=25.0, interpret=True)
    r, o = np.asarray(ref), np.asarray(out)
    assert np.max(np.abs(r - o)) / np.max(np.abs(r)) < 1e-5


def test_basis_kernel_batch_matches_jnp_basis(tangent_fixture):
    nu, kl, dnc, dsx, dy, dam = tangent_fixture
    B = 3
    ncB = jnp.stack([kl.nu_c + 0.01 * b for b in range(B)])
    sxB = jnp.stack([kl.scale_x * (1 + 0.05 * b) for b in range(B)])
    yB = jnp.stack([kl.y * (1 + 0.1 * b) for b in range(B)])
    C1B = jnp.stack([dam] * B)
    C2B = jnp.stack([kl.amps * (-sxB[b] * dnc)[None, :] for b in range(B)])
    C3B = jnp.stack([kl.amps * (dsx / sxB[b])[None, :] for b in range(B)])
    C4B = jnp.stack([kl.amps * dy[None, :]] * B)
    outB = basis_contract_pallas_batch_jit(
        nu, ncB, sxB, yB, C1B, C2B, C3B, C4B, tile_p=128, block_l=128,
        cutoff_cm1=25.0, interpret=True)
    for b in range(B):
        refb = _tangent_via_basis(nu, ncB[b], sxB[b], yB[b], kl.amps,
                                  dnc, dsx, dy, dam, chunk=64,
                                  variant="humlicek4", cutoff_cm1=25.0)
        r, o = np.asarray(refb), np.asarray(outB[b])
        assert np.max(np.abs(r - o)) / np.max(np.abs(r)) < 1e-5, b


def test_jacfwd_pallas_engine_matches_jnp():
    """End-to-end: jacfwd through the limb forward with engine='pallas'
    routes BOTH structural vmaps and the tangent vmap through the
    custom_vmap rules into the fused kernel, and matches the jnp engine."""
    P, n_lev, n_rays = 160, 5, 3
    ll = co2_15um_band(j_max=16)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3)
    # The suite conftest enables x64; this test exercises the f32 kernel
    # path.
    atm = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                       if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                       else a, atm)
    nu64 = np.linspace(620.0, 680.0, P)
    nu = jnp.asarray(nu64, jnp.float32)
    nu_off = jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32)
    ths = jnp.asarray(np.linspace(10e3, 60e3, n_rays), jnp.float32)

    def make(engine, interpret):
        def f(T):
            cg = limb_path_cg(atm.with_temperature(T), ["CO2"], ths, MARS, 2)
            return limb_radiance(nu, dl, cg, nu_off=nu_off, engine=engine,
                                 interpret=interpret).reshape(-1)
        return f

    T0 = atm.T.astype(jnp.float32)
    f_jnp, f_pal = make("jnp", False), make("pallas", True)
    y1, y2 = f_jnp(T0), f_pal(T0)
    assert float(jnp.max(jnp.abs(y1 - y2)) / jnp.max(jnp.abs(y1))) < 1e-5
    # jvp primal (from the fused basis pass) equals the forward
    yp = jax.jvp(f_pal, (T0,), (jnp.ones_like(T0),))[0]
    assert float(jnp.max(jnp.abs(yp - y2)) / jnp.max(jnp.abs(y2))) < 1e-5
    J1 = jax.jacfwd(f_jnp)(T0)
    J2 = jax.jacfwd(f_pal)(T0)
    assert bool(jnp.isfinite(J2).all())
    assert float(jnp.max(jnp.abs(J1 - J2)) / jnp.max(jnp.abs(J1))) < 1e-5


def test_rev_mode_kernel_transpose_parity():
    """Reverse mode with engine='pallas' (kernel primal with baked
    windows, analytic jnp transpose in the backward) matches the jnp
    engine at f32 roundoff, including under structural vmap (custom_vjp
    batching + the kernel's batching rule)."""
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.ops.opacity import (
        line_kernel_inputs, make_accumulate_op)
    from spectrobot_tpu.ops.pallas_opacity import static_windows
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    ll = random_lines(700, 600.0, 750.0, seed=7)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                            amp_weights=jnp.ones((2, dl.n_lines),
                                                 jnp.float32))
    nu = jnp.asarray(np.linspace(600.0, 750.0, 1024), jnp.float32)
    w = static_windows(np.asarray(nu), np.asarray(dl.nu0), cutoff_cm1=25.0)
    op_jnp = make_accumulate_op(mode="rev", engine="jnp", cutoff_cm1=25.0)
    op_pal = make_accumulate_op(mode="rev", engine="pallas", interpret=True,
                                cutoff_cm1=25.0, windows=w)
    args = (nu, kl.nu_c, kl.scale_x, kl.y, kl.amps)
    loss = lambda op: lambda *a: jnp.sum(jnp.sin(op(*a) * 1e3))
    g_ref = jax.grad(loss(op_jnp), argnums=(1, 2, 3, 4))(*args)
    g_pal = jax.grad(loss(op_pal), argnums=(1, 2, 3, 4))(*args)
    for a, b in zip(g_ref, g_pal):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-5,
                                   atol=float(jnp.abs(a).max()) * 2e-6)

    # Structural vmap (the per-layer batch shape).
    klb = jax.tree.map(lambda x: jnp.stack([x, x * 1.01]), kl)
    fp = jax.vmap(lambda nc, sx, y, am: jnp.sum(op_pal(nu, nc, sx, y, am) ** 2))
    fr = jax.vmap(lambda nc, sx, y, am: jnp.sum(op_jnp(nu, nc, sx, y, am) ** 2))
    gp = jax.grad(lambda am: jnp.sum(fp(klb.nu_c, klb.scale_x, klb.y, am)))(klb.amps)
    gr = jax.grad(lambda am: jnp.sum(fr(klb.nu_c, klb.scale_x, klb.y, am)))(klb.amps)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gr), rtol=1e-6,
                               atol=float(jnp.abs(gr).max()) * 1e-7)
