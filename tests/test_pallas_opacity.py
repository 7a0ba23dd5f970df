"""Pallas kernel P1 parity vs the jnp stage-2 path (SURVEY.md 5.4: kernels
get an interpret=True CPU test; on-chip parity runs in tests/test_chip.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops.opacity import accumulate_jnp, line_kernel_inputs
from spectrobot_tpu.ops.pallas_opacity import _block_windows, accumulate_pallas
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


def _kl(n_lines=700, seed=0):
    ll = random_lines(n_lines, 640.0, 700.0, seed=seed)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32, nu_ref=0.0)
    w = jnp.ones((2, dl.n_lines), jnp.float32).at[1].mul(0.5)
    return line_kernel_inputs(dl, 220.0, 300.0, 100.0, amp_weights=w)


@pytest.mark.parametrize("cutoff", [25.0, None])
def test_interpret_parity(cutoff):
    kl = _kl()
    nu = jnp.asarray(np.linspace(640, 700, 1500), jnp.float32)
    ref = np.asarray(accumulate_jnp(nu, kl, chunk=256, variant="humlicek4",
                                    cutoff_cm1=cutoff))
    got = np.asarray(accumulate_pallas(nu, kl, tile_p=256, block_l=256,
                                       cutoff_cm1=cutoff, interpret=True))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=scale * 1e-7)


def test_interpret_parity_awkward_sizes():
    # P and L not multiples of the tile/block sizes — padding paths.
    kl = _kl(n_lines=333)
    nu = jnp.asarray(np.linspace(650, 690, 777), jnp.float32)
    ref = np.asarray(accumulate_jnp(nu, kl, chunk=128, variant="humlicek4",
                                    cutoff_cm1=10.0))
    got = np.asarray(accumulate_pallas(nu, kl, tile_p=256, block_l=128,
                                       cutoff_cm1=10.0, interpret=True))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=scale * 1e-7)


def test_block_windows_cover_cutoff():
    nu = np.linspace(600.0, 700.0, 1024).astype(np.float32)
    nuc = np.sort(np.random.default_rng(0).uniform(550, 750, 2048)).astype(np.float32)
    starts, counts = _block_windows(nu, nuc, 256, 256, 25.0)
    n_blocks = len(nuc) // 256
    blk = nuc.reshape(n_blocks, 256)
    for t in range(len(nu) // 256):
        lo, hi = nu[t * 256], nu[(t + 1) * 256 - 1]
        needed = {b for b in range(n_blocks)
                  if (blk[b].max() >= lo - 25.0) and (blk[b].min() <= hi + 25.0)}
        covered = set(range(starts[t], starts[t] + counts[t]))
        assert needed <= covered


def test_block_windows_dense():
    nu = np.linspace(600.0, 700.0, 512).astype(np.float32)
    nuc = np.linspace(600, 700, 512).astype(np.float32)
    starts, counts = _block_windows(nu, nuc, 256, 256, None)
    assert np.all(starts == 0) and np.all(counts == 2)


def test_batched_interpret_parity():
    # The production path: one pallas_call over the whole (ray x layer)
    # batch, windows from unshifted nu0 + shift margin.
    import jax
    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import co2_15um_band
    from spectrobot_tpu.forward.geometry import limb_path_cg
    from spectrobot_tpu.forward.limb import (
        layer_tau, layer_tau_pallas, limb_radiance, limb_radiance_pallas,
    )
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    atm = mars_standard_atmosphere(n_lev=9, z_top=70e3)
    atm = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, atm)
    dl = device_lines_from_linelist(co2_15um_band(j_max=12), [(2, 1)],
                                    dtype=jnp.float32)
    nu = jnp.asarray(np.linspace(655, 680, 500), jnp.float32)
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray([8e3, 30e3], jnp.float32),
                      MARS, n_sub=2)
    ref = layer_tau(nu, dl, cg, None, chunk=128, cutoff_cm1=25.0)
    got = layer_tau_pallas(nu, dl, cg, None, cutoff_cm1=25.0, interpret=True)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), np.asarray(g)
        np.testing.assert_allclose(g, r, rtol=3e-5,
                                   atol=np.abs(r).max() * 1e-6)
    I_ref = np.asarray(jax.jit(
        lambda: limb_radiance(nu, dl, cg, chunk=128))())
    I_got = np.asarray(limb_radiance_pallas(nu, dl, cg, interpret=True))
    np.testing.assert_allclose(I_got, I_ref, rtol=3e-5,
                               atol=I_ref.max() * 1e-5)


def test_pallas_jit_engine_full_forward_parity():
    # The jit-composable pallas engine through the full differentiable
    # forward (layer_tau -> RT), interpret mode.
    import jax
    from spectrobot_tpu.data.atmosphere import MARS, mars_standard_atmosphere
    from spectrobot_tpu.data.synth import co2_15um_band
    from spectrobot_tpu.forward.geometry import limb_path_cg
    from spectrobot_tpu.forward.limb import limb_radiance

    atm = mars_standard_atmosphere(n_lev=7, z_top=60e3)
    atm = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, atm)
    dl = device_lines_from_linelist(co2_15um_band(j_max=10), [(2, 1)],
                                    dtype=jnp.float32)
    nu_host = np.linspace(660, 674, 500)
    nu = jnp.asarray(nu_host, jnp.float32)
    nu_off = jnp.asarray(nu_host - float(dl.nu_ref), jnp.float32)
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray([8e3, 30e3], jnp.float32),
                      MARS, n_sub=2)
    ref = np.asarray(jax.jit(lambda: limb_radiance(
        nu, dl, cg, chunk=128, nu_off=nu_off))())
    got = np.asarray(jax.jit(lambda: limb_radiance(
        nu, dl, cg, chunk=128, nu_off=nu_off, engine="pallas",
        interpret=True))())
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=ref.max() * 1e-6)


def test_static_windows_bit_parity():
    """Baked ragged windows (ops.pallas_opacity.static_windows) must be
    BIT-IDENTICAL to the all-blocks evaluation: windows only skip blocks
    the |dnu| <= cutoff mask would zero anyway (round-3 perf item — the
    windowed fused engine is ~20% faster at production scale)."""
    from spectrobot_tpu.ops.opacity import (
        KernelLines, accumulate_pallas_jit, line_kernel_inputs)
    from spectrobot_tpu.ops.pallas_opacity import (
        DEFAULT_BLOCK_L, static_windows)
    from spectrobot_tpu.data.synth import random_lines
    from spectrobot_tpu.ops.strengths import device_lines_from_linelist

    # Enough lines that even the 256-line default blocks leave something to
    # skip (round-5 geometry: DEFAULT_BLOCK_L=256 with 2 dispatch
    # sub-blocks per DMA block).
    ll = random_lines(1400, 600.0, 750.0, seed=5)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                            amp_weights=jnp.ones((2, dl.n_lines),
                                                 jnp.float32))
    nu = jnp.asarray(np.linspace(600.0, 750.0, 2048), jnp.float32)
    win = static_windows(np.asarray(nu), np.asarray(dl.nu0),
                         cutoff_cm1=25.0)
    n_blocks = -(-1400 // DEFAULT_BLOCK_L)
    # STRICT skipping: with default-size blocks and a 25 cm^-1 cutoff over
    # a 150 cm^-1 span, every tile's window must be well below all-blocks
    # (the old `< n_blocks + 1` form was vacuous — max(counts) can never
    # exceed n_blocks; round-3 ADVICE item 2).
    assert win[2] < n_blocks, (win[2], n_blocks)
    ref = np.asarray(accumulate_pallas_jit(nu, kl, cutoff_cm1=25.0,
                                           interpret=True))
    got = np.asarray(accumulate_pallas_jit(nu, kl, cutoff_cm1=25.0,
                                           interpret=True, windows=win))
    np.testing.assert_array_equal(got, ref)
