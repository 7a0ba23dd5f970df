"""Real-pair complex arithmetic helpers.

Pallas kernels have no complex dtype, so all complex math in the Voigt
evaluators is written over (re, im) tuples of real arrays.  These helpers are
dtype- and backend-agnostic: they work identically under jnp tracing, inside
Pallas kernel bodies, and on numpy arrays — which lets the exact same
line-shape math be unit-tested on CPU and compiled into the GPU kernel
(SURVEY.md section 8.3).
"""

from typing import Tuple

import jax.numpy as jnp

C = Tuple  # (re, im)


def cadd(a: C, b: C) -> C:
    return (a[0] + b[0], a[1] + b[1])


def csub(a: C, b: C) -> C:
    return (a[0] - b[0], a[1] - b[1])


def cmul(a: C, b: C) -> C:
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cscale(s, a: C) -> C:
    return (s * a[0], s * a[1])


def cadd_re(s, a: C) -> C:
    return (s + a[0], a[1])


def cdiv(a: C, b: C) -> C:
    d = b[0] * b[0] + b[1] * b[1]
    inv = 1.0 / d
    return ((a[0] * b[0] + a[1] * b[1]) * inv, (a[1] * b[0] - a[0] * b[1]) * inv)


def cinv(b: C) -> C:
    d = b[0] * b[0] + b[1] * b[1]
    inv = 1.0 / d
    return (b[0] * inv, -b[1] * inv)


def cexp(a: C) -> C:
    r = jnp.exp(a[0])
    return (r * jnp.cos(a[1]), r * jnp.sin(a[1]))


def cpolyval_real_coeffs(coeffs, z: C) -> C:
    """Horner evaluation of a polynomial with REAL coefficients at complex z.

    ``coeffs`` is an iterable of python floats, highest degree first.  Real
    coefficients halve the FLOPs of each Horner step versus complex ones:
    p = p*z + c needs one complex multiply and one real add.
    """
    pr = jnp.zeros_like(z[0]) + coeffs[0]
    pi = jnp.zeros_like(z[0])
    for c in coeffs[1:]:
        pr, pi = pr * z[0] - pi * z[1] + c, pr * z[1] + pi * z[0]
    return (pr, pi)
