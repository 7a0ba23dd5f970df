"""Voigt / complex-probability (Faddeeva) line-shape evaluators (C5).

The reference (fedef17/SpectRobot) evaluates Voigt profiles through a Fortran
Humlicek routine or ``scipy.special.wofz`` (SURVEY.md C5, 1.2).  Here the
equivalents here are branch-FREE evaluators built on real-pair complex
arithmetic (:mod:`spectrobot_tpu.ops.cpx`) so the identical math runs as pure
jnp (tests, reference path) and inside the Pallas opacity kernel (hot path,
SURVEY.md 8.3):

* :func:`wofz_weideman` — Weideman (1994) rational approximation, N-term,
  uniformly accurate in the upper half plane (~1e-6 rel at N=32 over the
  atmospheric (x, y) range; PAPERS.md:7 context).  Single formula, no region
  logic at all: ideal for the VPU.
* :func:`wofz_humlicek4` — Humlicek (1982) w4 four-region rational
  approximants evaluated branchlessly with ``jnp.where`` masks (~1e-4 rel):
  cheaper per point, used where speed beats the last two digits.

Conventions: w(z) = exp(-z^2) erfc(-iz), z = x + i y with y >= 0.
The area-normalised Voigt profile is
  V(nu) = sqrt(ln2/pi) / alpha_D * Re w(x + i y),
  x = sqrt(ln2) (nu - nu0') / alpha_D,  y = sqrt(ln2) gamma_L / alpha_D.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from spectrobot_tpu.constants import INV_SQRT_PI
from spectrobot_tpu.ops import cpx


# ---------------------------------------------------------------------------
# Weideman rational approximation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def weideman_coeffs(n_terms: int) -> Tuple[float, Tuple[float, ...]]:
    """Real polynomial coefficients of Weideman's rational approximation.

    Computed once host-side in float64 (FFT of the Gaussian sampled at tangent
    nodes, per Weideman 1994 'Computation of the Complex Error Function',
    SIAM J. Num. Anal.).  Returns (L, coeffs highest-degree-first).
    """
    N = n_terms
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t ** 2) * (L ** 2 + t ** 2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = a[1 : N + 1][::-1]  # highest degree first for Horner
    return float(L), tuple(float(c) for c in a)


def wofz_weideman(x, y, n_terms: int = 32):
    """Re and Im of w(x+iy) via the Weideman rational approximation.

    Valid for y >= 0.  Branch-free: one complex Moebius transform, one real-
    coefficient Horner chain of length ``n_terms``, two complex reciprocals.
    """
    L, coeffs = weideman_coeffs(n_terms)
    dt = jnp.result_type(x, y)
    Lc = jnp.asarray(L, dtype=dt)
    # iz = -y + i x ;  L - iz = L + y - i x
    denom = (Lc + y, -x)
    inv_denom = cpx.cinv(denom)           # 1/(L - iz)
    # Z = (L + iz)/(L - iz)
    Z = cpx.cmul((Lc - y, x), inv_denom)
    p = cpx.cpolyval_real_coeffs(coeffs, Z)
    inv2 = cpx.cmul(inv_denom, inv_denom)
    w = cpx.cadd(cpx.cscale(2.0, cpx.cmul(p, inv2)),
                 cpx.cscale(INV_SQRT_PI, inv_denom))
    return w


def wofz_weideman_grad(x, y, n_terms: int = 32):
    """w(z) plus f32-STABLE partials of K = Re w(x+iy), in one pass.

    Returns (wr, wi, dK_dx, dK_dy), differentiating the Weideman rational
    approximant IN CLOSED FORM (one extra real-coefficient Horner chain that
    shares the Moebius transform with the primal).

    Why not the exact identity w' = -2 z w + 2i/sqrt(pi)?  Measured: in
    float32 the identity's real part -2(x wr - y wi) cancels catastrophically
    in deep wings (at x ~ 1e4 the two products agree to ~8 digits, so the
    f32 result is pure rounding noise; worse, basis-decomposed opacity
    tangents defer the cancellation to AFTER the line reduction and corrupt
    Jacobians of optically thick layers).  The derivative of the approximant
    has no subtractive cancellation — every term carries the same
    D = 1/(L - iz) decay — and stays relative-accurate (~1e-6 at N=32) over
    the whole upper half plane (see tests/test_voigt.py).

        w  = 2 p(Z) D^2 + (1/sqrt(pi)) D,   D = 1/(L - iz),  Z = (L + iz) D
        dZ/dz = 2 i L D^2
        w' = i g,   g = 4 L p'(Z) D^4 + 4 p(Z) D^3 + (1/sqrt(pi)) D^2
        dK/dx = Re w' = -Im g,   dK/dy = Re(i w') = -Re g.
    """
    L, coeffs = weideman_coeffs(n_terms)
    n = len(coeffs)
    dcoeffs = tuple(c * (n - 1 - j) for j, c in enumerate(coeffs[:-1]))
    dt = jnp.result_type(x, y)
    Lc = jnp.asarray(L, dtype=dt)
    D = cpx.cinv((Lc + y, -x))
    Z = cpx.cmul((Lc - y, x), D)
    p = cpx.cpolyval_real_coeffs(coeffs, Z)
    dp = cpx.cpolyval_real_coeffs(dcoeffs, Z)
    D2 = cpx.cmul(D, D)
    D3 = cpx.cmul(D2, D)
    D4 = cpx.cmul(D2, D2)
    w = cpx.cadd(cpx.cscale(2.0, cpx.cmul(p, D2)), cpx.cscale(INV_SQRT_PI, D))
    g = cpx.cadd(cpx.cadd(cpx.cscale(4.0 * L, cpx.cmul(dp, D4)),
                          cpx.cscale(4.0, cpx.cmul(p, D3))),
                 cpx.cscale(INV_SQRT_PI, D2))
    return w[0], w[1], -g[1], -g[0]


# ---------------------------------------------------------------------------
# Humlicek w4 (branchless)
# ---------------------------------------------------------------------------

def wofz_humlicek4(x, y, *, with_region4: bool = True):
    """Re and Im of w(x+iy) via Humlicek's (1982) w4 algorithm, branchless.

    Regions selected by s = |x| + y:
      I  : s >= 15                  — 1-pole rational
      II : 5.5 <= s < 15            — 2-pole rational
      III: s < 5.5, y >= 0.195|x|-0.176 — 4th/5th-degree rational
      IV : s < 5.5, y <  0.195|x|-0.176 — exp(t^2) minus 6th/7th rational
    All four formulas are evaluated on masked-safe inputs and combined with
    ``jnp.where`` — no data-dependent control flow (XLA/Pallas friendly).

    ``with_region4=False`` (STATIC) skips region IV entirely — the only
    branch with transcendentals (cexp) and the deepest polynomials.  Valid
    (bit-identical to the full evaluator) when the caller PROVES no input
    pair satisfies the region-IV condition; since that condition needs
    y < 0.195|x| - 0.176 with |x| + y < 5.5, any block with
    min(y) >= 0.195*5.5 - 0.176 = 0.8965 qualifies (the Pallas kernel's
    block-level dispatch uses this with a 0.9 threshold for f32 slop).
    """
    t = (y, -x)              # t = y - i x
    s = jnp.abs(x) + y
    in12 = s >= 5.5
    in1 = s >= 15.0

    # Region I: w = t * invsqrtpi / (0.5 + t^2)
    u = cpx.cmul(t, t)
    w1 = cpx.cmul(cpx.cscale(INV_SQRT_PI, t), cpx.cinv(cpx.cadd_re(0.5, u)))

    # Region II: w = t (1.410474 + u*invsqrtpi) / (0.75 + u (3 + u))
    num2 = cpx.cmul(t, cpx.cadd_re(1.410474, cpx.cscale(INV_SQRT_PI, u)))
    den2 = cpx.cadd_re(0.75, cpx.cmul(u, cpx.cadd_re(3.0, u)))
    w2 = cpx.cmul(num2, cpx.cinv(den2))

    # Region III: w = N(t)/D(t), Humlicek's degree-4/5 rational in t,
    # written as expanded real-coefficient polynomials (module-level _N3/_D3,
    # highest degree first — shared with wofz_humlicek4_grad).
    w3 = cpx.cmul(cpx.cpolyval_real_coeffs(_N3, t),
                  cpx.cinv(cpx.cpolyval_real_coeffs(_D3, t)))

    if not with_region4:
        wr = jnp.where(in1, w1[0], jnp.where(in12, w2[0], w3[0]))
        wi = jnp.where(in1, w1[1], jnp.where(in12, w2[1], w3[1]))
        return (wr, wi)

    # Region IV: w = exp(u) - t*P(u)/Q(u), u = t^2.  Humlicek's nested
    # alternating forms expanded to plain polynomials (_P4/_Q4, highest
    # degree first).  exp(u) = exp(y^2 - x^2) cis(-2xy) is bounded here
    # (region IV requires s < 5.5), but masked-out lanes are clamped to keep
    # them finite.
    in4 = jnp.logical_and(~in12, y < 0.195 * jnp.abs(x) - 0.176)
    xr4 = jnp.where(in4, x, 0.0)
    yr4 = jnp.where(in4, y, 0.0)
    t4 = (yr4, -xr4)
    u4 = cpx.cmul(t4, t4)
    frac4 = cpx.cmul(cpx.cpolyval_real_coeffs(_P4, u4),
                     cpx.cinv(cpx.cpolyval_real_coeffs(_Q4, u4)))
    w4 = cpx.csub(cpx.cexp(u4), cpx.cmul(t4, frac4))

    wr = jnp.where(in1, w1[0], jnp.where(in12, w2[0], jnp.where(in4, w4[0], w3[0])))
    wi = jnp.where(in1, w1[1], jnp.where(in12, w2[1], jnp.where(in4, w4[1], w3[1])))
    return (wr, wi)


# Humlicek region-3/4 rational coefficients (shared with wofz_humlicek4;
# highest degree first) and their derivative polynomials.
_N3 = (0.5642236, 3.778987, 11.96482, 20.20933, 16.4955)
_D3 = (1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955)
_P4 = (0.56419, -1.320522, 35.76683, -219.0313, 1540.787, -3321.9905,
       36183.31)
_Q4 = (-1.0, 1.841439, -61.57037, 364.2191, -2186.181, 9022.228, -24322.84,
       32066.6)


def _poly_deriv(coeffs):
    n = len(coeffs)
    return tuple(c * (n - 1 - j) for j, c in enumerate(coeffs[:-1]))


def wofz_humlicek4_grad(x, y, *, with_region4: bool = True):
    """w(z) plus f32-stable partials of K = Re w, differentiating the
    Humlicek w4 approximant itself IN CLOSED FORM (region-consistent with
    :func:`wofz_humlicek4` — the derivative each region formula actually
    has, so analytic Jacobians match finite differences of the primal).

    Returns (wr, wi, dK_dx, dK_dy).  With t = y - i x and w = f(t):
    dw/dz = -i f'(t), hence dK/dx = Im f'(t) and dK/dy = Re f'(t).
    Region derivatives (u = t^2, c = 1/sqrt(pi), a = 1.410474):

      I  : f = c t/(0.5+u)            f' = c (0.5-u) / (0.5+u)^2
      II : f = t(a+cu)/(0.75+u(3+u))  f' = [0.75a + (2.25c-3a)u
                                            + 3(c-a)u^2 - c u^3] / D^2
      III: f = N3/D3                  f' = N3'/D3 - (N3/D3)(D3'/D3)
      IV : f = e^u - t P/Q            f' = 2t e^u - F - 2u F',
                                      F = P/Q, F' = P'/Q - F Q'/Q

    All divisions are STAGED through cinv (never |D|^4 in one product): at
    the wing extreme x ~ 1e5 the intermediate |denominator|^2 stays ~ x^4
    (f32-safe), where squaring the denominator first would overflow.
    Region III/IV values at masked-out large-|t| lanes may be inf (selected
    away by the region masks — inf is select-safe; region IV additionally
    clamps its inputs because exp overflows).  ~2.5x the primal's flops —
    versus ~6x for :func:`wofz_weideman_grad` — and unlike the exact
    identity w' = -2zw + 2i/sqrt(pi) it has NO subtractive cancellation in
    deep wings (see wofz_weideman_grad's conditioning note).
    """
    c = INV_SQRT_PI
    a = 1.410474
    t = (y, -x)
    s = jnp.abs(x) + y
    in12 = s >= 5.5
    in1 = s >= 15.0

    u = cpx.cmul(t, t)

    # Region I
    inv1 = cpx.cinv(cpx.cadd_re(0.5, u))
    w1 = cpx.cmul(cpx.cscale(c, t), inv1)
    g1 = cpx.cmul(cpx.cscale(c, cpx.csub((0.5, jnp.zeros_like(u[1])), u)),
                  cpx.cmul(inv1, inv1))

    # Region II
    num2 = cpx.cmul(t, cpx.cadd_re(a, cpx.cscale(c, u)))
    inv2 = cpx.cinv(cpx.cadd_re(0.75, cpx.cmul(u, cpx.cadd_re(3.0, u))))
    w2 = cpx.cmul(num2, inv2)
    _ND2 = (-c, 3.0 * (c - a), 2.25 * c - 3.0 * a, 0.75 * a)
    g2 = cpx.cmul(cpx.cmul(cpx.cpolyval_real_coeffs(_ND2, u), inv2), inv2)

    # Region III: share invD3 between primal and derivative.
    invD3 = cpx.cinv(cpx.cpolyval_real_coeffs(_D3, t))
    w3 = cpx.cmul(cpx.cpolyval_real_coeffs(_N3, t), invD3)
    g3 = cpx.csub(cpx.cmul(cpx.cpolyval_real_coeffs(_poly_deriv(_N3), t), invD3),
                  cpx.cmul(w3, cpx.cmul(
                      cpx.cpolyval_real_coeffs(_poly_deriv(_D3), t), invD3)))

    if not with_region4:
        # See wofz_humlicek4: bit-identical to the full evaluator whenever
        # the caller proves region IV is empty (min(y) >= 0.8965).
        sel3 = lambda v1, v2, v3: jnp.where(in1, v1, jnp.where(in12, v2, v3))
        return (sel3(w1[0], w2[0], w3[0]), sel3(w1[1], w2[1], w3[1]),
                sel3(g1[1], g2[1], g3[1]), sel3(g1[0], g2[0], g3[0]))

    # Region IV (inputs clamped outside the region: exp overflows there).
    in4 = jnp.logical_and(~in12, y < 0.195 * jnp.abs(x) - 0.176)
    xr4 = jnp.where(in4, x, 0.0)
    yr4 = jnp.where(in4, y, 0.0)
    t4 = (yr4, -xr4)
    u4 = cpx.cmul(t4, t4)
    invQ = cpx.cinv(cpx.cpolyval_real_coeffs(_Q4, u4))
    F = cpx.cmul(cpx.cpolyval_real_coeffs(_P4, u4), invQ)
    eu = cpx.cexp(u4)
    w4 = cpx.csub(eu, cpx.cmul(t4, F))
    dF = cpx.csub(cpx.cmul(cpx.cpolyval_real_coeffs(_poly_deriv(_P4), u4), invQ),
                  cpx.cmul(F, cpx.cmul(
                      cpx.cpolyval_real_coeffs(_poly_deriv(_Q4), u4), invQ)))
    g4 = cpx.csub(cpx.cscale(2.0, cpx.cmul(t4, eu)),
                  cpx.cadd(F, cpx.cscale(2.0, cpx.cmul(u4, dF))))

    sel = lambda v1, v2, v3, v4: jnp.where(
        in1, v1, jnp.where(in12, v2, jnp.where(in4, v4, v3)))
    wr = sel(w1[0], w2[0], w3[0], w4[0])
    wi = sel(w1[1], w2[1], w3[1], w4[1])
    kx = sel(g1[1], g2[1], g3[1], g4[1])   # dK/dx = Im f'
    ky = sel(g1[0], g2[0], g3[0], g4[0])   # dK/dy = Re f'
    return wr, wi, kx, ky


def voigt_profile(dnu, alpha_d, gamma_l, variant: str = "weideman", n_terms: int = 32):
    """Area-normalised Voigt profile V(dnu) [1/cm^-1].

    dnu = nu - nu0' (shift already applied), alpha_d = Doppler HWHM [cm-1],
    gamma_l = Lorentz HWHM [cm-1].  Broadcasting applies.
    """
    sqrt_ln2 = math.sqrt(math.log(2.0))
    sqrt_ln2_pi = math.sqrt(math.log(2.0) / math.pi)
    inv_ad = 1.0 / alpha_d
    x = sqrt_ln2 * dnu * inv_ad
    y = sqrt_ln2 * gamma_l * inv_ad
    if variant == "weideman":
        wr, _ = wofz_weideman(x, y, n_terms=n_terms)
    elif variant == "humlicek4":
        wr, _ = wofz_humlicek4(x, y)
    else:
        raise ValueError(f"unknown voigt variant {variant!r}")
    return sqrt_ln2_pi * inv_ad * wr
