"""Stage-discharge rating curves as device pytrees.

Replaces the reference's ``RatingCurve`` class hierarchy
(ref: src/hydromodel/rating_curve.py:3-162 and the GERD case's
``RoseiresRatingCurve``, ref: cases/gerd_roseires/roseires_rating_curve.py)
with a single pytree whose static ``kind`` selects a pure evaluation path at
trace time:

* ``polynomial``   Q = a x^2 + b x + c,  x = stage + shift   (ref :57-58)
* ``power``        Q = a x^b                                  (ref :61)
* ``blended_poly`` Q = (1-alpha) P_low(stage) + alpha P_high(stage) with a
  smoothstep alpha over a buffer above a pivot stage — the pure (smooth=True)
  Roseires release path (ref roseires_rating_curve.py:89-109); P_low/P_high
  are quadratics precomputed on the host from the gate states.
* ``table``        linear interpolation of a (stage, Q) table.

``dQ_dz`` is analytic for polynomial/power (ref :132-147) and a central
finite difference with the reference's exact step for blended_poly
(ref roseires_rating_curve.py:202-208, dY=0.001) and table curves.

Host-side ``fit`` replicates ref :84-130 (least squares polynomial, or
log-log power fit).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from flowsim_tpu.config import farray


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RatingCurveParams:
    kind: str = field(metadata=dict(static=True))
    coeffs: jnp.ndarray        # poly: [a,b,c]; power: [a,b]; blended: low [c2,c1,c0]
    coeffs_high: jnp.ndarray   # blended: high-state quadratic [c2,c1,c0]
    stage_shift: jnp.ndarray   # scalar
    pivot_stage: jnp.ndarray   # blended: alpha ramp start (initial stage)
    buffer: jnp.ndarray        # blended: alpha ramp width
    fd_step: jnp.ndarray       # finite-difference step for dQ/dz
    table_stage: jnp.ndarray   # table kind
    table_q: jnp.ndarray
    # gated_blend kind only: gate-controller cooldown (ref roseires:52-53)
    max_cooldown: jnp.ndarray = None


def _empty():
    from flowsim_tpu.config import default_dtype
    return jnp.zeros((0,), dtype=default_dtype())


def make_polynomial(a, b, c, stage_shift=0.0) -> RatingCurveParams:
    return RatingCurveParams(
        kind="polynomial",
        coeffs=farray([a, b, c]),
        coeffs_high=_empty(),
        stage_shift=farray(stage_shift),
        pivot_stage=jnp.asarray(0.0),
        buffer=jnp.asarray(0.0),
        fd_step=jnp.asarray(1e-3),
        table_stage=_empty(),
        table_q=_empty(),
    )


def make_polynomial_general(coefficients, stage_shift=0.0) -> RatingCurveParams:
    """Arbitrary-degree polynomial rating: ``coefficients`` ascending
    (c0 + c1 x + ... + cN x^N) in the shifted stage x = stage + shift.

    The reference's ``scale=True`` fit path supports any degree (ref
    rating_curve.py:84,101-105 stores a numpy Polynomial and evaluates it);
    kind="poly_n" is the device evaluation of the same fit, usable as a
    boundary rating or a junction release curve."""
    return RatingCurveParams(
        kind="poly_n",
        coeffs=farray(np.atleast_1d(coefficients)),
        coeffs_high=_empty(),
        stage_shift=farray(stage_shift),
        pivot_stage=jnp.asarray(0.0),
        buffer=jnp.asarray(0.0),
        fd_step=jnp.asarray(1e-3),
        table_stage=_empty(),
        table_q=_empty(),
    )


def make_power(a, b, stage_shift=0.0) -> RatingCurveParams:
    return RatingCurveParams(
        kind="power",
        coeffs=farray([a, b]),
        coeffs_high=_empty(),
        stage_shift=farray(stage_shift),
        pivot_stage=jnp.asarray(0.0),
        buffer=jnp.asarray(0.0),
        fd_step=jnp.asarray(1e-3),
        table_stage=_empty(),
        table_q=_empty(),
    )


def make_blended_poly(low_quad, high_quad, pivot_stage, buffer=0.5, fd_step=1e-3) -> RatingCurveParams:
    """Smooth gated-release curve: quadratics in stage for the closed (low)
    and open (high) gate states, blended by the reference's smoothstep
    (ref roseires_rating_curve.py:98-109).

    The quadratics are re-based around the pivot stage before storage: in the
    raw basis the three terms are ~1e6 and cancel to ~1e4, so any relative
    rounding is amplified ~100x in absolute terms.  Centered, the terms are
    O(Q) and the evaluation is exact to ~1e-12 on every backend; parity tests
    pin these values, which is why the centered form stays.
    """

    def center(quad, s0):
        c2, c1, c0 = [float(v) for v in quad]
        return [c2, 2.0 * c2 * s0 + c1, (c2 * s0 + c1) * s0 + c0]

    s0 = float(pivot_stage)
    return RatingCurveParams(
        kind="blended_poly",
        coeffs=farray(center(low_quad, s0)),
        coeffs_high=farray(center(high_quad, s0)),
        stage_shift=jnp.asarray(0.0),
        pivot_stage=farray(pivot_stage),
        buffer=farray(buffer),
        fd_step=farray(fd_step),
        table_stage=_empty(),
        table_q=_empty(),
    )


def make_table(stages, discharges, fd_step=1e-3) -> RatingCurveParams:
    return RatingCurveParams(
        kind="table",
        coeffs=_empty(),
        coeffs_high=_empty(),
        stage_shift=jnp.asarray(0.0),
        pivot_stage=jnp.asarray(0.0),
        buffer=jnp.asarray(0.0),
        fd_step=farray(fd_step),
        table_stage=farray(stages),
        table_q=farray(discharges),
    )


def make_gated_blend(low_quad, high_quad, pivot_stage, max_cooldown=3600 * 5, fd_step=1e-3) -> RatingCurveParams:
    """Non-smooth gated release: discharge follows the low (closed) or high
    (open) quadratic depending on an explicit gate state carried across time
    levels, with the reference's hysteresis thresholds (open at pivot + 0.5,
    close at pivot - 1) and cooldown (ref roseires_rating_curve.py:111-141).

    The reference mutates the gate state *during* Newton iterations, which is
    iteration-order-dependent; here (per SURVEY.md §7) the state updates once
    per time level from the previous level's converged downstream stage —
    the deterministic, scan-carried formulation.
    """
    base = make_blended_poly(low_quad, high_quad, pivot_stage, buffer=0.5, fd_step=fd_step)
    return RatingCurveParams(
        kind="gated_blend",
        coeffs=base.coeffs,
        coeffs_high=base.coeffs_high,
        stage_shift=base.stage_shift,
        pivot_stage=base.pivot_stage,
        buffer=base.buffer,
        fd_step=base.fd_step,
        table_stage=base.table_stage,
        table_q=base.table_q,
        max_cooldown=farray(max_cooldown),
    )


def gated_discharge(rc: RatingCurveParams, stage, gate_open):
    """Release under an explicit gate state (ref roseires:84-96)."""
    ds = stage - rc.pivot_stage
    low = _quad(rc.coeffs, ds)
    high = _quad(rc.coeffs_high, ds)
    return jnp.where(gate_open > 0.5, high, low)


def gated_dQ_dz(rc: RatingCurveParams, stage, gate_open):
    d = rc.fd_step
    return (gated_discharge(rc, stage + d, gate_open) - gated_discharge(rc, stage - d, gate_open)) / (2.0 * d)


def gate_update(rc: RatingCurveParams, gate_open, cooldown, prev_time, current_stage, time):
    """One gate-controller step (ref roseires:111-141): decrement cooldown by
    elapsed time, then open/close on the hysteresis thresholds."""
    elapsed = jnp.where(prev_time >= 0.0, time - prev_time, 0.0)
    cooldown = jnp.maximum(0.0, cooldown - elapsed)
    can_act = cooldown <= 0.0
    want_open = (current_stage >= rc.pivot_stage + 0.5) & (gate_open < 0.5)
    want_close = (current_stage <= rc.pivot_stage - 1.0) & (gate_open > 0.5)
    do_open = can_act & want_open
    do_close = can_act & want_close
    gate_open = jnp.where(do_open, 1.0, jnp.where(do_close, 0.0, gate_open))
    cooldown = jnp.where(do_open | do_close, rc.max_cooldown, cooldown)
    return gate_open, cooldown, time


def _quad(c, x):
    return (c[0] * x + c[1]) * x + c[2]


def discharge(rc: RatingCurveParams, stage):
    """Q(stage); pure, vectorized (ref rating_curve.py:32-63)."""
    if rc.kind == "polynomial":
        x = stage + rc.stage_shift
        a, b, c = rc.coeffs[0], rc.coeffs[1], rc.coeffs[2]
        return a * x * x + b * x + c
    if rc.kind == "poly_n":
        # Horner on the ascending coefficient row (any degree); same
        # evaluation as the reference's stored Polynomial object
        # (ref rating_curve.py:51-52) after domain conversion
        x = stage + rc.stage_shift
        return jnp.polyval(rc.coeffs[::-1], x)
    if rc.kind == "power":
        x = stage + rc.stage_shift
        a, b = rc.coeffs[0], rc.coeffs[1]
        return a * x ** b
    if rc.kind == "blended_poly":
        alpha = _alpha_smooth(rc, stage)
        ds = stage - rc.pivot_stage  # centered basis (see make_blended_poly)
        low = _quad(rc.coeffs, ds)
        high = _quad(rc.coeffs_high, ds)
        # low + a*(high-low), NOT (1-a)*low + a*high: the single-product
        # delta form rounds once where the two-product form can round twice
        # (and fma-contract differently per backend).  Same real algebra;
        # parity tests pin the values of this form.
        return low + alpha * (high - low)
    if rc.kind == "table":
        return jnp.interp(stage, rc.table_stage, rc.table_q)
    raise ValueError(f"unknown rating curve kind {rc.kind!r}")


def _alpha_smooth(rc: RatingCurveParams, stage):
    """smoothstep ramp from pivot to pivot+buffer (ref roseires:98-109).

    ``buffer == 0`` degenerates to the reference's step function (its
    >=/<= branches); guard the division so stage == pivot gives 0/eps = 0
    instead of 0/0 = NaN poisoning Newton."""
    s = (stage - rc.pivot_stage) / jnp.maximum(rc.buffer, 1e-30)
    s = jnp.clip(s, 0.0, 1.0)
    return 3.0 * s * s - 2.0 * s * s * s


def dQ_dz(rc: RatingCurveParams, stage):
    """dQ/d(stage) (ref rating_curve.py:132-147; roseires:202-208)."""
    if rc.kind == "polynomial":
        x = stage + rc.stage_shift
        return rc.coeffs[0] * 2.0 * x + rc.coeffs[1]
    if rc.kind == "poly_n":
        x = stage + rc.stage_shift
        dcoef = rc.coeffs[1:] * jnp.arange(1, rc.coeffs.shape[0], dtype=rc.coeffs.dtype)
        return jnp.polyval(dcoef[::-1], x)
    if rc.kind == "power":
        x = stage + rc.stage_shift
        a, b = rc.coeffs[0], rc.coeffs[1]
        return a * b * x ** (b - 1.0)
    # blended_poly / table: central finite difference, replicating the
    # Roseires dQ_dz exactly (dY = 0.001 by default).
    d = rc.fd_step
    return (discharge(rc, stage + d) - discharge(rc, stage - d)) / (2.0 * d)


def inverse_stage(rc: RatingCurveParams, q_target, trial_stage=None, tolerance=1e-2, rate=1.0, max_iter=64):
    """Stage from discharge by Newton iteration (ref rating_curve.py:65-82).

    Fixed-count masked Newton so it jits/vmaps; matches the reference loop
    semantics (iterate while |Q - target| > tolerance).
    """
    if trial_stage is None:
        trial_stage = -rc.stage_shift * 1.05

    def body(_, carry):
        s = carry
        qv = discharge(rc, s)
        active = jnp.abs(qv - q_target) > tolerance
        step = -rate * (qv - q_target) / dQ_dz(rc, s)
        return jnp.where(active, s + step, s)

    return jax.lax.fori_loop(0, max_iter, body, jnp.asarray(trial_stage, dtype=jnp.result_type(float)))


# ---------------------------------------------------------------------------
# Host-side fitting (NumPy)
# ---------------------------------------------------------------------------


def fit(discharges, stages, stage_shift=0.0, type: str = "polynomial", degree: int = 2) -> RatingCurveParams:
    """Least-squares fit, replicating ref rating_curve.py:84-130.

    polynomial: plain degree-2 polyfit on shifted stages (the reference's
    ``scale=True`` path uses numpy Polynomial.fit with a mapped domain; we
    convert to plain coefficients, which evaluates identically).
    power: log-log linear fit.
    """
    discharges = np.asarray(discharges, dtype=np.float64)
    stages = np.asarray(stages, dtype=np.float64)
    if discharges.size < 3:
        raise ValueError("Need at least 3 points.")
    if discharges.shape != stages.shape:
        raise ValueError("Q and Y lists should have the same lengths.")
    shifted = stages + stage_shift
    if np.any(shifted <= 0):
        raise ValueError("All (stage - base) values must be positive for power-law fitting.")

    if type == "polynomial":
        poly = np.polynomial.polynomial.Polynomial.fit(x=shifted, y=discharges, deg=degree)
        coef = poly.convert().coef
        coef = np.pad(coef, (0, degree + 1 - len(coef)))  # trailing zeros trimmed by convert()
        if degree != 2:
            # the reference's scale=True path supports any degree (ref
            # rating_curve.py:84,101-105); evaluate via the general kind
            return make_polynomial_general(coef, stage_shift=stage_shift)
        c0, c1, c2 = coef
        return make_polynomial(a=c2, b=c1, c=c0, stage_shift=stage_shift)
    elif type == "power":
        b, log_a = np.polyfit(np.log(shifted), np.log(discharges), deg=1)
        return make_power(a=float(np.exp(log_a)), b=float(b), stage_shift=stage_shift)
    raise ValueError("Invalid rating curve type.")


def fit_quadratic_bivariate(X, y):
    """Least-squares degree-2 bivariate polynomial with intercept.

    Equivalent to sklearn Pipeline(PolynomialFeatures(2, include_bias=False),
    LinearRegression) used for the Roseires spillway/sluice tables
    (ref roseires_rating_curve.py:229-257).  Returns coefficients
    [b0, b1, b2, b11, b12, b22] for 1, x1, x2, x1^2, x1*x2, x2^2.
    """
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x1, x2 = X[:, 0], X[:, 1]
    design = np.column_stack([np.ones_like(x1), x1, x2, x1 * x1, x1 * x2, x2 * x2])
    coef, *_ = np.linalg.lstsq(design, y, rcond=None)
    return coef


def eval_quadratic_bivariate(coef, x1, x2):
    b0, b1, b2, b11, b12, b22 = coef
    return b0 + b1 * x1 + b2 * x2 + b11 * x1 * x1 + b12 * x1 * x2 + b22 * x2 * x2
