"""Sub-Lorentzian chi wing-correction hook (round-4 review item 9).

Contract: default OFF is bit-identical; with ``lines.chi = "co2_mars"``
the Perrin-Hartmann first-segment factor applies per line (species-masked,
per-state T-dependent slope) identically in the jnp and Pallas engines,
matches the independent scipy.wofz oracle, and physically suppresses the
far wing.  Jacobians follow the frozen-chi convention (ops/chi.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.synth import co2_15um_band, co_fundamental
from spectrobot_tpu.ops.chi import (
    CHI_DELTA1, CHI_PROFILES, chi_factor_np,
)
from spectrobot_tpu.ops.opacity import (
    accumulate_jnp, line_kernel_inputs, make_accumulate_op,
)
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


@pytest.fixture(scope="module")
def scene():
    dl = device_lines_from_linelist(co2_15um_band(j_max=10), [(2, 1)],
                                    dtype=jnp.float64)
    prof = CHI_PROFILES["co2_mars"]
    kl = line_kernel_inputs(dl, 210.0, 500.0, 480.0, chi=(prof, (True,)))
    nu = jnp.asarray(np.linspace(640.0, 700.0, 768) - float(dl.nu_ref))
    return dl, prof, kl, nu


def test_profile_slope_temperature_dependence():
    prof = CHI_PROFILES["co2_mars"]
    # P&H first-segment slope: grows with T over the Mars range, >= 0.
    b = np.asarray([float(prof.slope(T)) for T in (140.0, 200.0, 270.0)])
    assert np.all(b >= 0) and np.all(np.diff(b) > 0)


def test_chi_off_is_bit_identical(scene):
    dl, prof, kl, nu = scene
    out_none = np.asarray(accumulate_jnp(nu, kl._replace(chi_b=None),
                                         cutoff_cm1=25.0))
    out_zero = np.asarray(accumulate_jnp(
        nu, kl._replace(chi_b=jnp.zeros_like(kl.y)), cutoff_cm1=25.0))
    np.testing.assert_array_equal(out_none, out_zero)


def test_chi_matches_scipy_oracle(scene):
    dl, prof, kl, nu = scene
    out = np.asarray(accumulate_jnp(nu, kl, cutoff_cm1=25.0,
                                    variant="weideman"))
    nuv = np.asarray(nu)
    nc = np.asarray(kl.nu_c); sx = np.asarray(kl.scale_x)
    yv = np.asarray(kl.y); am = np.asarray(kl.amps[0])
    cb = np.asarray(kl.chi_b)
    from scipy.special import wofz
    ref = np.zeros_like(nuv)
    for i in range(len(nc)):
        dnu = nuv - nc[i]
        K = wofz(sx[i] * dnu + 1j * yv[i]).real
        K = K * chi_factor_np(np.abs(dnu), cb[i])
        ref += am[i] * np.where(np.abs(dnu) <= 25.0, K, 0.0)
    np.testing.assert_allclose(out[0], ref, rtol=1e-5,
                               atol=np.abs(ref).max() * 1e-9)


def test_chi_suppresses_wings_not_cores(scene):
    dl, prof, kl, nu = scene
    on = np.asarray(accumulate_jnp(nu, kl, cutoff_cm1=25.0))
    off = np.asarray(accumulate_jnp(nu, kl._replace(chi_b=None),
                                    cutoff_cm1=25.0))
    assert np.all(on <= off + 1e-300)          # multiplicative, chi <= 1
    # At >20 cm^-1 from every line the suppression approaches
    # exp(-b*(20-3)) < 0.75; near cores it is ~1.
    nuv = np.asarray(nu); nc = np.asarray(kl.nu_c)
    dist = np.min(np.abs(nuv[None, :] - nc[:, None]), axis=0)
    wing = (dist > 20.0) & (dist < 25.0) & (off[0] > 0)
    assert wing.any()
    ratio = on[0, wing] / off[0, wing]
    assert ratio.max() < 0.75
    # Near cores chi ~ 1 for the DOMINANT line, but neighbours' wings are
    # still suppressed — allow their few-percent share.
    core = dist < 1.0
    np.testing.assert_allclose(on[0, core], off[0, core], rtol=2e-2)
    # And the global suppression is bounded by the analytic floor.
    b_max = float(np.asarray(kl.chi_b).max())
    floor = np.exp(-b_max * (25.0 - CHI_DELTA1))
    pos = off[0] > 0
    assert np.all(on[0, pos] / off[0, pos] >= floor * (1 - 1e-9))


def test_chi_engine_parity_primal_and_tangent(scene):
    """jnp vs Pallas (interpret) with chi ON: primal and the fused-basis
    tangent agree (both engines use the frozen-chi convention)."""
    dl, prof, _, _ = scene
    dl32 = device_lines_from_linelist(co2_15um_band(j_max=10), [(2, 1)],
                                      dtype=jnp.float32)
    kl = line_kernel_inputs(dl32, 210.0, 500.0, 480.0, chi=(prof, (True,)))
    nu = jnp.asarray(np.linspace(640.0, 700.0, 512) - float(dl32.nu_ref),
                     jnp.float32)
    op_j = make_accumulate_op(engine="jnp", mode="fwd", has_chi=True,
                              cutoff_cm1=25.0)
    op_p = make_accumulate_op(engine="pallas", mode="fwd", has_chi=True,
                              cutoff_cm1=25.0, interpret=True)
    args = (kl.nu_c, kl.scale_x, kl.y, kl.amps, kl.chi_b)
    a = np.asarray(op_j(nu, *args))
    b = np.asarray(op_p(nu, *args))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=np.abs(a).max() * 1e-7)
    tang = (jnp.zeros_like(kl.nu_c), jnp.full_like(kl.scale_x, 1e-3),
            jnp.full_like(kl.y, 1e-3), jnp.full_like(kl.amps, 1e-5),
            jnp.zeros_like(kl.chi_b))
    _, tj = jax.jvp(lambda *a_: op_j(nu, *a_), args, tang)
    _, tp = jax.jvp(lambda *a_: op_p(nu, *a_), args, tang)
    np.testing.assert_allclose(np.asarray(tj), np.asarray(tp), rtol=1e-5,
                               atol=float(jnp.abs(tj).max()) * 1e-6)


def test_chi_rev_mode_engine_parity(scene):
    """Reverse-mode (custom VJP / in-kernel transposed basis) carries chi
    with the same frozen-chi convention: grads agree across engines and
    match the forward-mode tangent via the dot-product identity."""
    dl, prof, _, _ = scene
    dl32 = device_lines_from_linelist(co2_15um_band(j_max=10), [(2, 1)],
                                      dtype=jnp.float32)
    kl = line_kernel_inputs(dl32, 210.0, 500.0, 480.0, chi=(prof, (True,)))
    nu = jnp.asarray(np.linspace(640.0, 700.0, 512) - float(dl32.nu_ref),
                     jnp.float32)
    mk = lambda eng: make_accumulate_op(engine=eng, mode="rev",
                                        has_chi=True, cutoff_cm1=25.0,
                                        interpret=eng == "pallas")
    args = (kl.nu_c, kl.scale_x, kl.y, kl.amps, kl.chi_b)
    loss = lambda op: (lambda nc, sx, y, am, cb:
                       jnp.sum(op(nu, nc, sx, y, am, cb) ** 2))
    g_j = jax.grad(loss(mk("jnp")), argnums=(0, 1, 2, 3))(*args)
    g_p = jax.grad(loss(mk("pallas")), argnums=(0, 1, 2, 3))(*args)
    for a, b in zip(g_j, g_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=float(jnp.abs(a).max()) * 1e-5)
    # fwd/rev consistency: <grad, v> == d/dt loss(x + t v).
    op_f = make_accumulate_op(engine="jnp", mode="fwd", has_chi=True,
                              cutoff_cm1=25.0)
    v = tuple(jnp.full_like(a, 1e-4) for a in args[:4])
    _, jvp_val = jax.jvp(
        lambda nc, sx, y, am: jnp.sum(op_f(nu, nc, sx, y, am,
                                           kl.chi_b) ** 2),
        args[:4], v)
    dot = sum(jnp.vdot(g, vi) for g, vi in zip(g_j, v))
    np.testing.assert_allclose(float(dot), float(jvp_val), rtol=1e-4)


def test_chi_species_masking():
    """chi applies ONLY to the profile's species: CO lines are untouched
    while CO2 lines are wing-suppressed, in one mixed line sum."""
    co2 = co2_15um_band(j_max=8)
    co = co_fundamental(j_max=6)
    co.nu0[:] = co.nu0 - 2143.27 + 655.0
    ll = co2.concat(co)
    dl = device_lines_from_linelist(ll, [(2, 1), (5, 1)], dtype=jnp.float64)
    prof = CHI_PROFILES["co2_mars"]
    # rows: (CO2,1), (CO,1) -> mask (True, False)
    kl_on = line_kernel_inputs(dl, 210.0, 500.0, 100.0,
                               chi=(prof, (True, False)))
    co_rows = np.asarray(dl.species_idx) == 1
    assert np.all(np.asarray(kl_on.chi_b)[co_rows] == 0.0)
    assert np.all(np.asarray(kl_on.chi_b)[~co_rows] > 0.0)


def test_cli_chi_forward_and_guards(tmp_path, capsys):
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "chi.toml"
    cfg.write_text(f"""
[grid]
nu_min = 676.0
nu_max = 690.0
n_points = 160
[scene]
n_levels = 6
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[compute]
dtype = "float64"
[lines]
chi = "co2_mars"
[run]
output_dir = "{tmp_path}/chi_on"
save_optics = true
""")
    assert main(["forward", str(cfg)]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/chi_on/forward.npz") as z:
        on = z["values"]
    with np.load(f"{tmp_path}/chi_on/optics.npz") as z:
        tau_on = z["values"]
    assert main(["forward", str(cfg), "-o", "lines.chi=",
                 "-o", f"run.output_dir={tmp_path}/chi_off"]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/chi_off/forward.npz") as z:
        off = z["values"]
    with np.load(f"{tmp_path}/chi_off/optics.npz") as z:
        tau_off = z["values"]
    # chi is multiplicative <= 1 on the OPTICAL DEPTH (the radiance is not
    # monotone in tau for inhomogeneous paths — less foreground absorption
    # can pass MORE back-layer emission), and visibly changes this
    # wing-only window.
    assert np.all(tau_on <= tau_off * (1 + 1e-12))
    assert np.max(np.abs(tau_off - tau_on)) > 0.1   # O(1) in tau units
    assert np.max(np.abs(on - off)) > 1e-5 * off.max()
    # Guards: unknown profile, cutoff beyond the implemented segment,
    # unsupported tiers.
    with pytest.raises(KeyError, match="co2_mars"):
        main(["forward", str(cfg), "-o", "lines.chi=nope"])
    with pytest.raises(ValueError, match="cutoff"):
        main(["forward", str(cfg), "-o", "compute.cutoff_cm1=40.0"])
    # chi x LUT: the wing correction BAKES into the table (b(T) rides the
    # lattice T axis), so the LUT forward tracks the direct chi forward to
    # interpolation error and differs from a chi-off LUT.
    assert main(["forward", str(cfg), "-o", "compute.use_lut=true",
                 "-o", "run.save_optics=false",
                 "-o", f"run.output_dir={tmp_path}/chi_lut"]) == 0
    assert main(["forward", str(cfg), "-o", "compute.use_lut=true",
                 "-o", "run.save_optics=false", "-o", "lines.chi=",
                 "-o", f"run.output_dir={tmp_path}/nochi_lut"]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/chi_lut/forward.npz") as z:
        lut_on = z["values"]
    with np.load(f"{tmp_path}/nochi_lut/forward.npz") as z:
        lut_off = z["values"]
    np.testing.assert_allclose(lut_on, on, rtol=0.05,
                               atol=0.02 * on.max())
    assert np.max(np.abs(lut_on - lut_off)) > 1e-5 * lut_off.max()
    # chi x MESH works and matches the single-device chi forward exactly
    # (the static chi tuple flows into every layer_tau call in the
    # shard_map body; f64 jnp engine both sides).
    if len(jax.devices()) >= 8:
        assert main(["forward", str(cfg), "-o", "compute.mesh_nu=8",
                     "-o", "run.save_optics=false",
                     "-o", f"run.output_dir={tmp_path}/chi_mesh"]) == 0
        capsys.readouterr()
        with np.load(f"{tmp_path}/chi_mesh/forward.npz") as z:
            mesh_on = z["values"]
        np.testing.assert_allclose(mesh_on, on, rtol=1e-10)


def test_cli_chi_retrieval_converges(tmp_path, capsys):
    """End-to-end: a self-test retrieval with chi enabled converges (the
    frozen-chi Jacobian is consistent enough for LM steps)."""
    from spectrobot_tpu.cli import main
    cfg = tmp_path / "chir.toml"
    cfg.write_text(f"""
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 160
[scene]
n_levels = 6
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 40
[compute]
dtype = "float64"
[lines]
chi = "co2_mars"
[retrieval]
max_iter = 8
[run]
output_dir = "{tmp_path}/chir"
""")
    assert main(["retrieve", str(cfg)]) == 0
    capsys.readouterr()
    with np.load(f"{tmp_path}/chir/retrieval.npz") as z:
        assert bool(z["converged"])
