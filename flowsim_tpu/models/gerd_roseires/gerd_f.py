"""Darcy-Weisbach friction factors for the GERD bottom outlets.

Counterpart of the reference's engineering scratch script
(ref cases/gerd_roseires/gerd_f.py:5-49): Swamee-Jain explicit estimate and
the Colebrook-White equation for twin circular barrels over a grid of total
discharges and concrete roughnesses.

Vectorized restyling: instead of the reference's scalar loops with a
data-dependent iteration count, the Colebrook solve is one vectorized
fixed-count fixed-point iteration over the whole (Q, eps) grid — the same
rearrangement 1/sqrt(f) = -2 log10(eps/(3.7 D) + 2.51/(Re sqrt(f))), run to
machine fixed point (the map is strongly contractive; 50 sweeps are far past
double-precision convergence for any turbulent Re).

Run as a script: ``python -m flowsim_tpu.models.gerd_roseires.gerd_f``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Parameters (ref gerd_f.py:24-28)
DIAMETER = 6.0            # m, barrel diameter
NU = 1.003e-6             # m^2/s kinematic viscosity at ~20 C
EPS_VALUES = (1e-4, 3e-4, 1e-3)   # m, smooth to rough concrete
Q_LIST = (50.0, 200.0, 500.0, 1000.0, 3000.0, 5000.0)  # m^3/s, twin barrels


def swamee_jain(Re, eps, D=DIAMETER):
    """Explicit Swamee-Jain estimate (ref gerd_f.py:5-6)."""
    Re = jnp.asarray(Re)
    return 0.25 / jnp.log10(eps / (3.7 * D) + 5.74 / Re**0.9) ** 2


def colebrook(Re, eps, D=DIAMETER, n_iter: int = 50):
    """Colebrook-White friction factor, vectorized fixed-count fixed point.

    Laminar branch f = 64/Re below Re = 2000 (ref gerd_f.py:8-22).  The
    iteration count is static (jit/vmap-friendly); the rearranged map
    converges to double precision in ~10 sweeps.
    """
    Re = jnp.asarray(Re)
    # clamp only BELOW the laminar/turbulent switch: the reference evaluates
    # the turbulent fixed point at the actual Re for any Re >= 2000, and the
    # laminar branch is selected below it anyway — the clamp just keeps the
    # unused turbulent value finite there
    Re_t = jnp.maximum(Re, 2000.0)
    f0 = swamee_jain(Re_t, eps, D)

    def body(f, _):
        rhs = -2.0 * jnp.log10(eps / (3.7 * D) + 2.51 / (Re_t * jnp.sqrt(f)))
        return 1.0 / rhs**2, None

    f, _ = jax.lax.scan(body, f0, None, length=n_iter)
    return jnp.where(Re < 2000.0, 64.0 / Re, f)


def friction_table(Q_list=Q_LIST, eps_values=EPS_VALUES, D=DIAMETER, nu=NU):
    """All (Q, eps) combinations at once (ref gerd_f.py:30-44 loop).

    Returns a dict of 1-D arrays: Q_total, eps, V (per barrel), Re,
    f_swamee_jain, f_colebrook.
    """
    Q = jnp.asarray(Q_list)
    eps = jnp.asarray(eps_values)
    A = jnp.pi * D * D / 4.0
    V = (Q / 2.0) / A                   # per-barrel velocity (twin barrels)
    Re = V * D / nu

    shape = (Q.size, eps.size)
    Qg = jnp.broadcast_to(Q[:, None], shape)
    epsg = jnp.broadcast_to(eps[None, :], shape)
    Vg = jnp.broadcast_to(V[:, None], shape)
    Reg = jnp.broadcast_to(Re[:, None], shape)
    f_sj = swamee_jain(Reg, epsg, D)
    f_cb = colebrook(Reg, epsg, D)
    flat = lambda a: np.asarray(a).reshape(-1)
    return dict(Q_total=flat(Qg), eps=flat(epsg), V=flat(Vg), Re=flat(Reg),
                f_swamee_jain=flat(f_sj), f_colebrook=flat(f_cb))


def main():
    # host-side preprocessing table: an 18-row grid does not warrant an
    # accelerator compile (or reserving the card's memory)
    jax.config.update("jax_platforms", "cpu")
    t = friction_table()
    header = f"{'Q_total_m3s':>12} {'eps_m':>8} {'V_m_s':>9} {'Re':>12} {'f_SJ':>10} {'f_CB':>10}"
    print(header)
    for i in range(len(t["Q_total"])):
        print(f"{t['Q_total'][i]:12.0f} {t['eps'][i]:8.0e} {t['V'][i]:9.4f} "
              f"{int(t['Re'][i]):12d} {t['f_swamee_jain'][i]:10.6f} {t['f_colebrook'][i]:10.6f}")


if __name__ == "__main__":
    main()
