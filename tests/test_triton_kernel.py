"""The Triton opacity kernels (ops/pallas_opacity.py) in interpret mode,
plus the engine policy and compile-cache plumbing around them.

Covers the wrapper's contract where a GPU is not needed: row padding of
the contraction (multiply-and-sum rows vs 16-row dot chunks), window
tables (empty windows, windowed == all-blocks bit for bit), the
inactive-state skip, the chi factor, awkward P/L padding with non-default
tiles — each against the jnp reference."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops import pallas_opacity as po
from spectrobot_tpu.ops.opacity import (
    _basis, accumulate_jnp, line_kernel_inputs,
)
from spectrobot_tpu.ops.strengths import device_lines_from_linelist

CUT = 10.0


def _states(n_states=2, n_lines=90, n_points=200, seed=0):
    """f32 kernel inputs for a few states of one random line list."""
    ll = random_lines(n_lines, 640.0, 670.0, seed=seed)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kls = [line_kernel_inputs(dl, 180.0 + 40.0 * b, 50.0 * (b + 1), 10.0,
                              amp_weights=jnp.ones((2, dl.n_lines),
                                                   jnp.float32))
           for b in range(n_states)]
    stack = lambda f: jnp.stack([f(kl) for kl in kls])
    nu = jnp.asarray(np.linspace(645.0, 665.0, n_points), jnp.float32)
    return (nu, np.asarray(dl.nu0), stack(lambda k: k.nu_c),
            stack(lambda k: k.scale_x), stack(lambda k: k.y),
            stack(lambda k: k.amps))


def _ref_basis(nu, nu_c, sx, y, coeffs, chi_b=None):
    out = []
    for b in range(nu_c.shape[0]):
        basis = _basis(nu, nu_c[b], sx[b], y[b],
                       None if chi_b is None else chi_b[b],
                       variant="humlicek4", cutoff_cm1=CUT, dt=jnp.float32)
        out.append(sum(np.asarray(c[b], np.float64) @ np.asarray(B, np.float64)
                       for c, B in zip(coeffs, basis)))
    return np.stack(out)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n_rows", [2, 5, 16, 33])
def test_basis_row_padding(n_rows):
    """Row counts on both contraction paths: <= 4 rows multiply-and-sum,
    more rows go through 16-row HIGHEST dots (5 -> 16, 33 -> 48 padded
    rows, sliced back)."""
    nu, _, nu_c, sx, y, amps = _states()
    key = jax.random.PRNGKey(n_rows)
    coeffs = [jax.random.normal(k, (2, n_rows, nu_c.shape[1]), jnp.float32)
              * amps[:, :1, :] for k in jax.random.split(key, 4)]
    got = po.basis_contract_pallas_batch_jit(
        nu, nu_c, sx, y, *coeffs, tile_p=64, block_l=32, cutoff_cm1=CUT,
        interpret=True)
    assert got.shape == (2, n_rows, nu.shape[0])
    assert _rel(got, _ref_basis(nu, nu_c, sx, y, coeffs)) < 1e-5


def test_empty_windows_give_zero():
    """A tile whose window holds no block (count 0) runs no iterations and
    writes exact zeros; the other tiles are unaffected."""
    nu, nu0, nu_c, sx, y, amps = _states(n_states=1)
    st, ct, mb = po.static_windows(np.asarray(nu), nu0, tile_p=64,
                                   block_l=32, cutoff_cm1=CUT)
    ct_empty = ct.copy()
    ct_empty[1] = 0
    kw = dict(tile_p=64, block_l=32, cutoff_cm1=CUT, interpret=True)
    full = np.asarray(po.accumulate_pallas_batch_jit(
        nu, nu_c, sx, y, amps, windows=(st, ct, mb), **kw))
    got = np.asarray(po.accumulate_pallas_batch_jit(
        nu, nu_c, sx, y, amps, windows=(st, ct_empty, mb), **kw))
    assert np.all(got[..., 64:128] == 0.0)
    np.testing.assert_array_equal(got[..., :64], full[..., :64])
    np.testing.assert_array_equal(got[..., 128:], full[..., 128:])
    assert np.abs(full[..., 64:128]).max() > 0


def test_inactive_state_skip():
    """States with all-zero amplitudes (dead limb layers) are skipped and
    give exact zeros; a live state forced inactive proves the skip runs."""
    nu, _, nu_c, sx, y, amps = _states(n_states=3)
    amps = amps.at[1].set(0.0)
    kw = dict(tile_p=64, block_l=32, cutoff_cm1=CUT, interpret=True)
    got = np.asarray(po.accumulate_pallas_batch_jit(nu, nu_c, sx, y, amps,
                                                    **kw))
    assert np.all(got[1] == 0.0) and np.abs(got[0]).max() > 0
    C = amps[:, :1, :]
    forced = np.asarray(po.basis_contract_pallas_batch_jit(
        nu, nu_c, sx, y, C, C, C, C, active=jnp.asarray([1, 0, 0]), **kw))
    assert np.all(forced[1:] == 0.0) and np.abs(forced[0]).max() > 0


@pytest.mark.parametrize("kind", ["primal", "basis"])
def test_windowed_equals_all_blocks(kind):
    """Baked windows skip only blocks the cutoff mask would zero anyway:
    results are bit-identical to visiting every block."""
    nu, nu0, nu_c, sx, y, amps = _states(n_lines=200)
    win = po.static_windows(np.asarray(nu), nu0, tile_p=64, block_l=32,
                            cutoff_cm1=CUT)
    assert win[1].max() < -(-nu_c.shape[1] // 32), "windows skip nothing"
    kw = dict(tile_p=64, block_l=32, cutoff_cm1=CUT, interpret=True)
    if kind == "primal":
        f = lambda w: po.accumulate_pallas_batch_jit(nu, nu_c, sx, y, amps,
                                                     windows=w, **kw)
    else:
        C = jnp.concatenate([amps] * 3, axis=1)
        f = lambda w: po.basis_contract_pallas_batch_jit(
            nu, nu_c, sx, y, C, 0.5 * C, 0.25 * C, 2.0 * C, windows=w, **kw)
    np.testing.assert_array_equal(np.asarray(f(win)), np.asarray(f(None)))


def test_chi_factor_in_kernel():
    """The sub-Lorentzian chi factor (ops/chi.py) in the primal kernel
    matches the jnp reference with the same slopes."""
    from spectrobot_tpu.ops.opacity import KernelLines

    nu, _, nu_c, sx, y, amps = _states(n_states=1)
    chi_b = jnp.full(nu_c.shape, 0.3, jnp.float32)
    got = po.accumulate_pallas_batch_jit(
        nu, nu_c, sx, y, amps, tile_p=64, block_l=32, cutoff_cm1=CUT,
        interpret=True, chi_b=chi_b)[0]
    ref = np.asarray(accumulate_jnp(
        nu, KernelLines(nu_c[0], sx[0], y[0], amps[0], chi_b[0]),
        chunk=64, cutoff_cm1=CUT))
    no_chi = np.asarray(accumulate_jnp(
        nu, KernelLines(nu_c[0], sx[0], y[0], amps[0]), chunk=64,
        cutoff_cm1=CUT))
    assert _rel(got, ref) < 1e-5
    assert np.max(np.abs(no_chi / ref - 1.0)) > 0.05   # visible in wings


@pytest.mark.parametrize("tile_p,block_l", [(32, 16), (128, 64)])
def test_awkward_padding(tile_p, block_l):
    """P and L far from tile/block multiples, non-default tile sizes."""
    nu, nu0, nu_c, sx, y, amps = _states(n_lines=77, n_points=301)
    win = po.static_windows(np.asarray(nu), nu0, tile_p=tile_p,
                            block_l=block_l, cutoff_cm1=CUT)
    got = po.accumulate_pallas_batch_jit(
        nu, nu_c, sx, y, amps, tile_p=tile_p, block_l=block_l,
        cutoff_cm1=CUT, interpret=True, windows=win)
    assert got.shape == (2, 2, 301)
    ref = _ref_basis(nu, nu_c, sx, y, (amps,))
    assert _rel(got, ref) < 1e-5


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,use_pallas,variant,want", [
    ("gpu", True, "humlicek4", "pallas"),
    ("gpu", False, "humlicek4", "jnp"),
    ("gpu", True, "weideman", "jnp"),
    ("cpu", True, "humlicek4", "jnp"),
])
def test_engine_policy(monkeypatch, platform, use_pallas, variant, want):
    """The kernel engine on a GPU; the jnp reference on any other backend
    or when the config turns the kernel off."""
    from spectrobot_tpu.cli import _engine
    from spectrobot_tpu.config import load_config

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)])
    cfg = load_config(None, {"compute.use_pallas": str(use_pallas).lower(),
                             "compute.variant": variant})
    assert _engine(cfg, 1000) == want


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """cli.main keeps the compile cache where JAX_COMPILATION_CACHE_DIR
    says, and in <checkout>/.jax_cache when it is unset."""
    from spectrobot_tpu import cli

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(cli.__file__))), ".jax_cache")
    try:
        assert cli.main(["info"]) == 0
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
