"""(P, T) LUT cache tier (C9) vs the direct line-sum path."""

import jax
import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import layer_tau
from spectrobot_tpu.ops.lut import (
    build_lut, interp_sigma, layer_tau_lut, load_lut, save_lut,
)
from spectrobot_tpu.ops.opacity import cross_sections
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


def _setup():
    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 400))
    lut = build_lut(nu, dl, n_species=1, T_min=140.0, T_max=280.0, n_T=15,
                    p_min=1e-2, p_max=1e3, n_p=21, vmr_self=[0.95], chunk=128)
    return dl, nu, lut


def test_lut_matches_direct_at_nodes_and_between():
    dl, nu, lut = _setup()
    # Exactly at a node: equality to build accuracy.
    T0 = float(lut.T_grid[7]); p0 = 10.0 ** float(lut.logp_grid[10])
    direct, _ = cross_sections(nu, dl, T0, p0, p_self_pa=0.95 * p0, chunk=128)
    got = interp_sigma(lut, T0, p0)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct), rtol=1e-10)
    # Between nodes: interpolation error only (grids chosen for ~<1%).
    T1, p1 = 201.7, 37.3
    direct, _ = cross_sections(nu, dl, T1, p1, p_self_pa=0.95 * p1, chunk=128)
    got = interp_sigma(lut, T1, p1)[0]
    d = np.asarray(direct); g = np.asarray(got)
    denom = np.maximum(d, d.max() * 1e-4)
    assert np.max(np.abs(g - d) / denom) < 0.05


def test_lut_layer_tau_close_to_direct(mars_atm):
    dl, nu, lut = _setup()
    cg = limb_path_cg(mars_atm, ["CO2"], jnp.asarray([10e3, 30e3]), MARS,
                      n_sub=2)
    dtau_direct, _ = layer_tau(nu, dl, cg, None, chunk=128)
    dtau_lut = layer_tau_lut(lut, cg)
    d = np.asarray(dtau_direct); g = np.asarray(dtau_lut)
    scale = d.max()
    assert np.max(np.abs(g - d)) / scale < 0.02


def test_lut_differentiable():
    dl, nu, lut = _setup()

    def f(T):
        return jnp.sum(interp_sigma(lut, T, 50.0))

    # T off the lattice nodes (bilinear interp has derivative kinks there).
    T0 = 203.7
    g = jax.grad(f)(T0)
    eps = 0.05
    fd = (f(T0 + eps) - f(T0 - eps)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), np.asarray(fd), rtol=1e-6)


def test_lut_round_trip(tmp_path):
    dl, nu, lut = _setup()
    p = str(tmp_path / "lut.npz")
    save_lut(lut, p)
    lut2 = load_lut(p)
    np.testing.assert_allclose(np.asarray(lut2.sigma), np.asarray(lut.sigma))
    got = interp_sigma(lut2, 210.0, 20.0)
    assert np.isfinite(np.asarray(got)).all()


def test_get_or_build_cache_hit_and_invalidation(tmp_path):
    """round-1 review item 5: persisted LUTs are keyed to a fingerprint
    of (line list, grid, lattice); a matching file skips the rebuild, any
    input change misses and rebuilds."""
    from spectrobot_tpu.ops.lut import get_or_build_lut

    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 200))
    path = str(tmp_path / "lut_cache.npz")
    lattice = dict(T_min=140.0, T_max=280.0, n_T=7, p_min=1e-2, p_max=1e3,
                   n_p=9, vmr_self=[0.95], chunk=128)
    lut1, cached1 = get_or_build_lut(path, nu, dl, 1, **lattice)
    assert not cached1
    lut2, cached2 = get_or_build_lut(path, nu, dl, 1, **lattice)
    assert cached2
    np.testing.assert_allclose(np.asarray(lut2.sigma), np.asarray(lut1.sigma))
    # Any lattice change invalidates ...
    _, cached3 = get_or_build_lut(path, nu, dl, 1,
                                  **{**lattice, "n_T": 8})
    assert not cached3
    # ... and so does a different line list (here: different nu_ref).
    dl2 = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                     dtype=jnp.float64, nu_ref=0.0)
    _, cached4 = get_or_build_lut(path, nu, dl2, 1, **{**lattice, "n_T": 8})
    assert not cached4


def test_mesh_build_matches_serial():
    """The lattice build sharded over the 8 emulated devices is identical to
    the serial build (the makeLUT* pool replacement, SURVEY.md 4.3)."""
    from spectrobot_tpu.ops.lut import lut_mesh

    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 200))
    lattice = dict(T_min=140.0, T_max=280.0, n_T=5, p_min=1e-2, p_max=1e3,
                   n_p=6, vmr_self=[0.95], chunk=128)
    assert len(jax.devices()) == 8
    lut_s = build_lut(nu, dl, n_species=1, **lattice)
    lut_m = build_lut(nu, dl, n_species=1, mesh=lut_mesh(), **lattice)
    np.testing.assert_allclose(np.asarray(lut_m.sigma),
                               np.asarray(lut_s.sigma), rtol=1e-12)


def test_mesh_build_nlte_matches_serial():
    from spectrobot_tpu.ops.lut import build_nlte_lut, lut_mesh

    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 120))
    lattice = dict(T_min=140.0, T_max=280.0, n_T=4, p_min=1e-2, p_max=1e3,
                   n_p=5, vmr_self=[0.95], chunk=128)
    lut_s = build_nlte_lut(nu, dl, n_species=1, **lattice)
    lut_m = build_nlte_lut(nu, dl, n_species=1, mesh=lut_mesh(), **lattice)
    for f in ("sigma_l", "sigma_u", "sigma_e"):
        np.testing.assert_allclose(np.asarray(getattr(lut_m, f)),
                                   np.asarray(getattr(lut_s, f)), rtol=1e-12)


def test_sharded_lut_forward_and_jacobian_parity():
    """LUT x mesh at the library level (parallel/sharded_lut.py): the
    sharded LUT forward AND its OE Jacobian (vmap-of-jvp through the
    bilinear tables) match the single-device LUT path to f64 roundoff on
    the 8-device emulated mesh."""
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 emulated devices")
    from spectrobot_tpu.parallel.mesh import make_mesh
    from spectrobot_tpu.parallel.oe import make_sharded_oe
    from spectrobot_tpu.retrieval.state import (
        build_forward_lut, flatten_state, make_state,
    )

    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float64)
    atm = mars_standard_atmosphere(n_lev=7, z_top=60e3)
    nu = jnp.asarray(np.linspace(660.0, 674.0, 256))
    lut = build_lut(nu, dl, 1, T_min=120.0, T_max=300.0, n_T=9,
                    p_min=1e-3, p_max=1.2e3, n_p=11, chunk=128)
    h_t = jnp.asarray([8e3, 16e3, 24e3, 32e3])
    state0 = make_state(atm, [])
    x0, unravel = flatten_state(state0)

    fwd = build_forward_lut(atm, lut, ["CO2"], MARS, tangent_heights_m=h_t,
                            n_sub=2)
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    y_ref = np.asarray(fwd_flat(x0))
    K_ref = np.asarray(jax.jacfwd(fwd_flat)(x0))

    mesh = make_mesh((2, 2, 2))
    oe = make_sharded_oe(mesh, atm, dl, nu, ["CO2"], MARS, h_t,
                         state_template=state0, n_sub=2, lut=lut)
    np.testing.assert_allclose(np.asarray(oe.forward_flat(x0)), y_ref,
                               rtol=1e-10, atol=np.abs(y_ref).max() * 1e-12)
    np.testing.assert_allclose(np.asarray(oe.jacobian(jnp.asarray(x0))),
                               K_ref, rtol=1e-8, atol=1e-16)
