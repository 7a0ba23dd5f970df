"""The Triton opacity kernels compiled for the GPU (no interpret mode).

Marked ``chip``: each test takes the ``gpu`` fixture, which skips on any
other backend.  Run on a GPU host with ``pytest --chip -m chip
tests/test_chip.py``; ``chip_smoke.py`` runs them in its kernel phase.
The parity bounds are IEEE float32 ones: a TF32 contraction (~1e-3
relative) or a wrong window would fail them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops import pallas_opacity as po
from spectrobot_tpu.ops.opacity import _basis, line_kernel_inputs
from spectrobot_tpu.ops.strengths import device_lines_from_linelist

pytestmark = pytest.mark.chip
CUT = 25.0


def _scene(n_states=8, n_lines=2048, n_points=8192):
    ll = random_lines(n_lines, 600.0, 750.0, seed=0)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kls = [line_kernel_inputs(dl, 150.0 + 15.0 * b, 10.0 ** (b - 3), 0.0,
                              amp_weights=jnp.ones((2, dl.n_lines),
                                                   jnp.float32))
           for b in range(n_states)]
    stack = lambda f: jnp.stack([f(kl) for kl in kls])
    nu = jnp.asarray(np.linspace(600.0, 750.0, n_points), jnp.float32)
    return (nu, np.asarray(dl.nu0), stack(lambda k: k.nu_c),
            stack(lambda k: k.scale_x), stack(lambda k: k.y),
            stack(lambda k: k.amps))


def _reference(nu, nu_c, sx, y, coeffs):
    """jnp basis (float32 evaluation, HIGHEST contraction) per state."""
    def one(nc, s, yy, *C):
        basis = _basis(nu, nc, s, yy, variant="humlicek4", cutoff_cm1=CUT,
                       dt=jnp.float32)
        return sum(jnp.matmul(c, b, precision=jax.lax.Precision.HIGHEST)
                   for c, b in zip(C, basis))
    return np.asarray(jax.jit(jax.vmap(one))(nu_c, sx, y, *coeffs))


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def test_primal_kernel_on_gpu(gpu):
    nu, nu0, nu_c, sx, y, amps = _scene()
    win = po.static_windows(np.asarray(nu), nu0, cutoff_cm1=CUT)
    got = jax.jit(lambda *a: po.accumulate_pallas_batch_jit(
        *a, cutoff_cm1=CUT, windows=win))(nu, nu_c, sx, y, amps)
    assert _rel(got, _reference(nu, nu_c, sx, y, (amps,))) < 1e-5


def test_basis_kernel_on_gpu(gpu):
    """66 rows (primal + a 32-column Jacobian of two spectra): the 16-row
    HIGHEST dot path."""
    nu, nu0, nu_c, sx, y, amps = _scene()
    coeffs = tuple(jax.random.normal(k, (nu_c.shape[0], 66, nu_c.shape[1]),
                                     jnp.float32) * amps[:, :1, :]
                   for k in jax.random.split(jax.random.PRNGKey(0), 4))
    win = po.static_windows(np.asarray(nu), nu0, cutoff_cm1=CUT)
    got = jax.jit(lambda *a: po.basis_contract_pallas_batch_jit(
        *a, cutoff_cm1=CUT, windows=win))(nu, nu_c, sx, y, *coeffs)
    assert _rel(got, _reference(nu, nu_c, sx, y, coeffs)) < 1e-5


def test_engine_policy_picks_kernel_on_gpu(gpu):
    from spectrobot_tpu.cli import _engine
    from spectrobot_tpu.config import Config
    assert _engine(Config(), 2048) == "pallas"
