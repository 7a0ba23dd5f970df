"""Tripwire: hot contractions must pin HIGHEST matmul precision.

An accelerator's DEFAULT f32 matmul runs at reduced precision (TF32 on a
GPU's tensor cores, ~1e-3 relative; bf16 passes elsewhere); that corrupted
radiances by ~0.4% and produced wrong-sign Jacobian tangents (cancelling
x^2*wr basis terms), breaking LM convergence end-to-end — found only by
running a full retrieval on hardware.  These tests inspect the jaxprs
(including the Triton kernel's body) so the pins cannot be silently dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.ops.opacity import (
    _tangent_via_basis, accumulate_jnp, line_kernel_inputs,
)
from spectrobot_tpu.ops.strengths import device_lines_from_linelist


def _dot_precisions(jaxpr):
    out = []

    def walk(jx):
        if hasattr(jx, "jaxpr"):            # ClosedJaxpr
            jx = jx.jaxpr
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params.get("precision"))
            for sub in eqn.params.values():
                subs = sub if isinstance(sub, (list, tuple)) else (sub,)
                for s2 in subs:
                    if hasattr(s2, "eqns") or hasattr(s2, "jaxpr"):
                        walk(s2)
    walk(jaxpr)
    return out


HIGHEST = (jax.lax.Precision.HIGHEST,) * 2


def _setup():
    dl = device_lines_from_linelist(co2_15um_band(j_max=8), [(2, 1)],
                                    dtype=jnp.float32)
    kl = line_kernel_inputs(dl, 220.0, 100.0, 50.0,
                            amp_weights=jnp.ones((2, dl.n_lines), jnp.float32))
    nu = jnp.asarray(np.linspace(-10, 10, 256), jnp.float32)
    return nu, kl


def test_accumulate_contraction_pins_highest():
    nu, kl = _setup()
    jx = jax.make_jaxpr(lambda: accumulate_jnp(nu, kl, chunk=128))()
    precs = _dot_precisions(jx)
    assert precs, "no dot_general found — did the contraction change?"
    for p in precs:
        assert p == HIGHEST, p


def test_tangent_contractions_pin_highest():
    nu, kl = _setup()
    zeros = (jnp.zeros_like(kl.nu_c), jnp.zeros_like(kl.scale_x),
             jnp.zeros_like(kl.y), jnp.zeros_like(kl.amps))
    jx = jax.make_jaxpr(lambda: _tangent_via_basis(
        nu, kl.nu_c, kl.scale_x, kl.y, kl.amps, *zeros,
        chunk=128, variant="humlicek4", cutoff_cm1=25.0))()
    precs = _dot_precisions(jx)
    assert len(precs) >= 4  # four stable-basis contractions (K, Kx, xKx, Ky)
    for p in precs:
        assert p == HIGHEST, p


def test_kernel_contraction_pins_highest():
    """The Triton kernel's row-chunk dots: IEEE float32, never TF32."""
    from spectrobot_tpu.ops.pallas_opacity import (
        basis_contract_pallas_batch_jit)
    nu, kl = _setup()
    C = jnp.tile(kl.amps, (1, 9, 1))                 # 18 rows: dot path
    jx = jax.make_jaxpr(lambda: basis_contract_pallas_batch_jit(
        nu, kl.nu_c[None], kl.scale_x[None], kl.y[None], C, C, C, C,
        interpret=True))()
    precs = _dot_precisions(jx)
    assert len(precs) >= 4, precs
    for p in precs:
        assert p == HIGHEST, p


def _other_contractions():
    from spectrobot_tpu.forward.rt import layer_path_radiance
    from spectrobot_tpu.ops.ils import apply_fov, apply_ils
    from spectrobot_tpu.retrieval.state import NodeBasis
    I = jnp.ones((4, 16), jnp.float32)
    nb = NodeBasis(np.linspace(0.0, 60e3, 13), np.linspace(0.0, 60e3, 4))
    return {
        "ils": lambda: apply_ils(I, jnp.ones((5, 16), jnp.float32)),
        "fov": lambda: apply_fov(I, jnp.ones((2, 4), jnp.float32)),
        "rt": lambda: layer_path_radiance(
            jnp.ones((3, 16), jnp.float32), jnp.ones((3, 16), jnp.float32),
            jnp.asarray([2, 1, 0, 0, 1, 2])),
        "node_basis": lambda: nb.expand(
            {"T": jnp.ones((4,), jnp.float32),
             "ln_vmr": {"CO": jnp.zeros((4,), jnp.float32)}}),
    }


@pytest.mark.parametrize("name", ["ils", "fov", "rt", "node_basis"])
def test_other_contractions_pin_highest(name):
    """ILS/FOV application, the RT layer scatter and the node-basis
    expansion: a TF32 node expansion alone moves a 200 K profile ~0.2 K."""
    precs = _dot_precisions(jax.make_jaxpr(_other_contractions()[name])())
    assert precs, f"no dot_general in {name}"
    for p in precs:
        assert p == HIGHEST, (name, p)
