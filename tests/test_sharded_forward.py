"""Full sharded forward (parallel/sharded.py, C21/C23) on the emulated mesh:
parity with the single-device model across mesh shapes, non-LTE, and
backgrounds (SURVEY.md 5.4 'assert bit-equality with the single-device
result')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu.data.nlte import (
    device_nlte, lte_t_vib, match_lines_to_levels, registry_from_linelist,
)
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.parallel.mesh import make_mesh
from spectrobot_tpu.parallel.sharded import (
    pad_lines_for_mesh, partition_lines_by_nu, sharded_radiance_fn,
    stage_sharded,
)


def _scene():
    atm = mars_standard_atmosphere(n_lev=11, z_top=80e3)
    ll = co2_15um_band(j_max=12)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float64)
    nu = jnp.asarray(np.linspace(655.0, 680.0, 512))
    h_t = jnp.asarray([10e3, 20e3, 30e3, 40e3])
    cg = limb_path_cg(atm, ["CO2"], h_t, MARS, n_sub=2)
    return ll, dl, nu, cg


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (4, 1, 2), (1, 1, 8)])
def test_sharded_matches_single_device(shape):
    ll, dl, nu, cg = _scene()
    ref = np.asarray(jax.jit(
        limb_radiance, static_argnames=("variant", "cutoff_cm1", "chunk"))(
        nu, dl, cg))
    mesh = make_mesh(shape)
    dlp = pad_lines_for_mesh(dl, shape[1])
    f = sharded_radiance_fn(mesh, has_nlte=False, has_background=False)
    nu_s, lines_s, cg_s, _, _ = stage_sharded(mesh, nu, dlp, cg)
    got = np.asarray(f(nu_s, lines_s, cg_s))
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)


@pytest.mark.parametrize("shape,engine,halo,windowed", [
    ((2, 2, 2), "jnp", True, False),      # nu-halo tier, XLA engine
    ((1, 1, 4), "jnp", True, False),      # pure nu decomposition with halo
    ((1, 2, 4), "jnp", True, False),      # halo composed with line sharding
    ((2, 2, 2), "pallas", False, False),  # Pallas kernel, line-psum tier
    ((1, 1, 4), "pallas", True, False),   # Pallas kernel + nu-halo (the
                                          # BASELINE.json:5 composition)
    ((2, 2, 2), "pallas", False, True),   # + per-shard static windows
    ((1, 2, 4), "pallas", True, True),    # windows x halo x line sharding
])
def test_sharded_engine_halo_matrix(shape, engine, halo, windowed):
    """The production engine x distribution matrix (round-2 review
    item 1): the Pallas kernel and the nu-halo line distribution each match
    the single-device result — jnp to f64 roundoff, pallas to the f32
    accumulation-order level of the kernel itself.  ``windowed`` adds the
    per-(shard, source) ragged kernel windows (round-3 sharded analog of
    static_windows, selected via lax.axis_index inside the body)."""
    ll, dl, nu, cg = _scene()
    # The grid spans 25 cm-1; halo exactness needs cutoff <= shard width
    # (here 25/4 = 6.25), so the whole matrix runs at 5 cm-1.
    cut = 5.0
    ref = np.asarray(jax.jit(lambda: limb_radiance(
        nu, dl, cg, cutoff_cm1=cut))())
    mesh = make_mesh(shape, jax.devices()[: int(np.prod(shape))])
    if halo:
        dlp = partition_lines_by_nu(dl, np.asarray(nu), shape[2],
                                    cutoff_cm1=cut, line_shards=shape[1])
    else:
        dlp = pad_lines_for_mesh(dl, shape[1])
    win_kw = {}
    if windowed:
        nu_off = np.asarray(nu, np.float64) - float(dl.nu_ref)
        win_kw = dict(win_grid=nu_off, win_lines=np.asarray(dlp.nu0))
    f = sharded_radiance_fn(mesh, has_nlte=False, has_background=False,
                            cutoff_cm1=cut, engine=engine, interpret=True,
                            nu_halo=halo, **win_kw)
    nu_s, lines_s, cg_s, _, _ = stage_sharded(mesh, nu, dlp, cg)
    got = np.asarray(f(nu_s, lines_s, cg_s))
    tol = 1e-10 if engine == "jnp" else 2e-6   # pallas runs in float32
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=np.abs(ref).max() * tol)


def test_halo_partition_guard():
    """cutoff > shard width must fail loudly (wings would skip a shard)."""
    ll, dl, nu, cg = _scene()
    with pytest.raises(ValueError, match="wing cutoff"):
        partition_lines_by_nu(dl, np.asarray(nu), 8, cutoff_cm1=25.0)


def test_sharded_nlte_and_background():
    ll, dl, nu, cg = _scene()
    reg = registry_from_linelist(ll)
    ll2 = match_lines_to_levels(ll, reg)
    dl = device_lines_from_linelist(ll2, [(2, 1)], dtype=jnp.float64)
    n_lay = cg.u.shape[1]
    t_vib = lte_t_vib(reg, 200.0 * np.ones(n_lay)) + 15.0
    nlte = device_nlte(reg, t_vib, dtype=jnp.float64)
    I_bg = jnp.full((nu.shape[0],), 1e-3)

    ref = np.asarray(jax.jit(
        lambda: limb_radiance(nu, dl, cg, nlte,))()
        ) + 0  # limb has no background arg; emulate with path_radiance below
    from spectrobot_tpu.forward.limb import layer_optics, path_radiance
    optics = layer_optics(nu, dl, cg, nlte)
    ref = np.asarray(path_radiance(
        optics, cg, jnp.broadcast_to(I_bg, (cg.u.shape[0], nu.shape[0]))))

    mesh = make_mesh((2, 2, 2))
    dlp = pad_lines_for_mesh(dl, 2)
    f = sharded_radiance_fn(mesh, has_nlte=True, has_background=True)
    nu_s, lines_s, cg_s, nlte_s, bg_s = stage_sharded(mesh, nu, dlp, cg,
                                                      nlte, I_bg)
    got = np.asarray(f(nu_s, lines_s, cg_s, nlte_s, bg_s))
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)


def test_padded_partition_multi_block_parity():
    """Regression (round-3 code-review): owner-shard slices spanning
    MULTIPLE 256-line kernel blocks with a padded tail must stay exact —
    a mid-band (0.0) pad fill used to break the sorted-centers invariant,
    silently dropping real blocks from the baked windows and
    mis-dispatching overlapping blocks to the far-wing formula.  The pad
    fill is now a far sentinel; this test forces Lmax=1024 (>=3 real
    blocks + a padded tail that ends a block with sentinels)."""
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    ll = random_lines(700, 656.0, 679.0, seed=9)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float64)
    atm = mars_standard_atmosphere(n_lev=7, z_top=80e3)
    nu = jnp.asarray(np.linspace(655.0, 680.0, 1024))
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray([10e3, 30e3]), MARS, 2)
    cut = 5.0
    # Reference: the SAME kernel single-device (isolates the mesh/window
    # path from the kernel's own f32-vs-f64 accumulation error, ~3e-4 at
    # 700 saturating random lines); f64 oracle as a sanity bound.
    ref = np.asarray(jax.jit(lambda: limb_radiance(
        nu, dl, cg, cutoff_cm1=cut, chunk=128, engine="pallas",
        interpret=True))())
    ref64 = np.asarray(jax.jit(lambda: limb_radiance(
        nu, dl, cg, cutoff_cm1=cut, chunk=128))())
    np.testing.assert_allclose(ref, ref64, rtol=2e-3,
                               atol=np.abs(ref64).max() * 1e-3)

    mesh = make_mesh((1, 1, 2), jax.devices()[:2])
    dlp = partition_lines_by_nu(dl, np.asarray(nu), 2, cutoff_cm1=cut,
                                round_to=1024)
    assert dlp.nu0.shape == (2, 1024)      # >= 3 real blocks + padded tail
    nu_off = np.asarray(nu, np.float64) - float(dl.nu_ref)
    f = sharded_radiance_fn(mesh, has_nlte=False, has_background=False,
                            cutoff_cm1=cut, chunk=128, engine="pallas",
                            interpret=True, nu_halo=True,
                            win_grid=nu_off, win_lines=np.asarray(dlp.nu0))
    nu_s, lines_s, cg_s, _, _ = stage_sharded(mesh, nu, dlp, cg)
    got = np.asarray(f(nu_s, lines_s, cg_s))
    np.testing.assert_allclose(got, ref, rtol=2e-6,
                               atol=np.abs(ref).max() * 2e-6)
