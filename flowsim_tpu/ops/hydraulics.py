"""Vectorized hydraulic closure functions.

Pure elementwise functions of per-node arrays — they replace the scalar
closures of the reference (ref: src/hydromodel/hydraulics.py:4-229) with
branch-free jnp code that XLA fuses into the surrounding stencil.  All
formulas are numerically identical to the reference (including its epsilon
clamps), so the Preissmann trajectories can be compared allclose.

Conventions
-----------
* ``A`` wetted area, ``P`` wetted perimeter, ``R = A/P`` hydraulic radius,
  ``T`` top width, ``K`` conveyance, ``n`` Manning roughness, ``h`` depth,
  ``Q`` discharge, ``rc`` radius of curvature (1/curvature).
* every function broadcasts over arbitrary leading shapes.
"""

from __future__ import annotations

import jax.numpy as jnp

from flowsim_tpu.config import GRAVITY as g

_EPS = 1e-30  # guards 0/0 only; never changes well-posed values


# -- fractional powers ------------------------------------------------------
# All the Manning-law exponents are multiples of 1/6, so they are expressed
# through sqrt (exact to 0.5 ulp) and a Newton-polished cube root instead of
# a general ``pow``, whose accuracy is backend-dependent: a sloppy pow floors
# the Newton residual above the reference's 1e-6 tolerance.  These agree with
# ``x ** p`` to ~1 ulp on the CPU, and the parity tests pin their values,
# which is why this form stays.


def _cbrt(x):
    # the x == 0 sentinel keeps autodiff finite: jnp.cbrt's derivative at 0
    # is +inf, and a downstream 0 * inf turns into NaN in both jvp and vjp
    # even when the 0-valued branch is the selected one (the adjoint path,
    # ops/adjoint.py, needs d/dh of every closure).  Values are unchanged:
    # x != 0 follows the exact old formula, x == 0 returns the same 0.
    zero_in = x == 0.0
    xs = jnp.where(zero_in, 1.0, x)
    r = jnp.cbrt(xs)
    # one Newton step restores full-precision roots even if cbrt is sloppy
    r2 = r * r
    r3 = r2 * r
    return jnp.where(zero_in, 0.0, r - (r3 - xs) / (3.0 * r2))


def pow_2_3(x):
    c = _cbrt(x)
    return c * c


def pow_m1_3(x):
    return 1.0 / _cbrt(x)


def pow_1_6(x):
    return jnp.sqrt(_cbrt(x))


def pow_3_2(x):
    # d/dx = sqrt(x) + x/(2 sqrt(x)) is 0/0 at x = 0; the sentinel keeps
    # jvp/vjp finite (the Horton sum feeds K = 0 inactive subsections here).
    # Values unchanged: x > 0 exact old formula, x <= 0 returns 0 (x = 0
    # returned 0 before; negative conveyances cannot occur).
    pos = x > 0.0
    xs = jnp.where(pos, x, 1.0)
    return jnp.where(pos, xs * jnp.sqrt(xs), 0.0)


def conveyance(A, n, R):
    """Manning conveyance K = A R^{2/3} / n  (ref: hydraulics.py:15-26)."""
    return A * pow_2_3(R) / n


def dK_dA(A, n, R, dR_dA):
    """dK/dA (ref: hydraulics.py:28-40)."""
    return (pow_2_3(R) + A * (2.0 / 3.0) * pow_m1_3(R) * dR_dA) / n


def friction_slope(Q, K):
    """Sf = Q|Q| / K^2  (ref: hydraulics.py:42-57)."""
    return Q * jnp.abs(Q) / (K * K)


def dSf_dA(Q, K, dK_dA_val):
    """dSf/dA = -2 Sf dK/dA / K  (ref: hydraulics.py:59-75)."""
    return -2.0 * friction_slope(Q, K) * (dK_dA_val / K)


def dSf_dQ(Q, K):
    """dSf/dQ = 2|Q| / K^2  (ref: hydraulics.py:77-92)."""
    return 2.0 * jnp.abs(Q) / (K * K)


def normal_flow(bed_slope, K):
    """Q = sign(S0) K sqrt(|S0|)  (ref: hydraulics.py:4-13)."""
    Q = K * jnp.sqrt(jnp.abs(bed_slope))
    return jnp.where(bed_slope < 0, -Q, Q)


def dQn_dA(bed_slope, dK_dA_val):
    """d(normal flow)/dA  (ref: hydraulics.py:206-215)."""
    d = dK_dA_val * jnp.sqrt(jnp.abs(bed_slope))
    return jnp.where(bed_slope < 0, -d, d)


def froude(T, A, Q):
    """Froude number with the reference's 1e-6 clamps (ref: hydraulics.py:155-168)."""
    V = Q / jnp.maximum(A, 1e-6)
    D = A / jnp.maximum(T, 1e-6)
    return V / jnp.sqrt(g * jnp.maximum(D, 1e-6))


def dFr_dA(T, A, Q):
    """dFr/dA (no clamps, matching ref: hydraulics.py:170-187)."""
    V = Q / A
    D = A / T
    dV_dA = -Q / (A * A)
    dD_dA = 1.0 / T
    gD = g * D
    inv_sqrt = 1.0 / jnp.sqrt(gD)
    return -0.5 * V * (inv_sqrt / gD) * g * dD_dA + dV_dA * inv_sqrt


def dFr_dQ(T, A):
    """dFr/dQ (ref: hydraulics.py:189-204)."""
    D = A / T
    return (1.0 / A) / jnp.sqrt(g * D)


def darcy_weisbach_f(n, R):
    """f = 8 g n^2 / R^{1/3}  (ref: hydraulics.py:217-229)."""
    C = pow_1_6(R) / n
    return 8.0 * g / (C * C)


# migration alias: the reference spells it "darcey" (ref hydraulics.py:217)
darcey_weisbach_f = darcy_weisbach_f


def curvature_slope(h, T, A, Q, n, R, rc):
    """Transverse-circulation energy slope Sc (ref: hydraulics.py:94-117).

    Sc = (2.86 sqrt(f) + 2.07 f) h^2 Fr^2 / ((0.565 + sqrt(f)) rc^2)
    """
    Fr = froude(T, A, Q)
    f = darcy_weisbach_f(n, R)
    sqrtf = jnp.sqrt(f)
    num = (2.86 * sqrtf + 2.07 * f) * h * h * Fr * Fr
    den = (0.565 + sqrtf) * rc * rc
    return num / den


def dSc_dA(h, A, Q, n, R, rc, dR_dA, T):
    """dSc/dA (ref: hydraulics.py:119-137)."""
    Fr = froude(T, A, Q)
    f = darcy_weisbach_f(n, R)
    dh_dA = 1.0 / T
    dFr = dFr_dA(A=A, Q=Q, T=T)
    df_dA = -(8.0 / 3.0) * g * n * n * (pow_m1_3(R) / R) * dR_dA

    sqrtf = jnp.sqrt(f)
    num = (2.86 * sqrtf + 2.07 * f) * h * h * Fr * Fr
    den = (0.565 + sqrtf) * rc * rc

    dnum_dA = (2.86 / (2.0 * sqrtf) * df_dA + 2.07 * df_dA) * h * h * Fr * Fr + (
        2.86 * sqrtf + 2.07 * f
    ) * (2.0 * h * dh_dA * Fr * Fr + h * h * 2.0 * Fr * dFr)
    dden_dA = (1.0 / (2.0 * sqrtf) * df_dA) * rc * rc
    return (dnum_dA * den - num * dden_dA) / (den * den)


def dSc_dQ(h, T, A, Q, n, R, rc):
    """dSc/dQ (ref: hydraulics.py:139-153)."""
    Fr = froude(T, A, Q)
    f = darcy_weisbach_f(n, R)
    dFr = dFr_dQ(T=T, A=A)
    sqrtf = jnp.sqrt(f)
    num = (2.86 * sqrtf + 2.07 * f) * h * h * Fr * Fr
    den = (0.565 + sqrtf) * rc * rc
    dnum_dQ = (2.86 * sqrtf + 2.07 * f) * h * h * 2.0 * Fr * dFr
    return dnum_dQ / den
