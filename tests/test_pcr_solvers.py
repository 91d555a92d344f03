"""block_pcr (f64) and pcr_f32 against dense and block-Thomas solves.

The sizes and right-hand-side shapes are those the long-reach and
single-block solvers have to cover: N from a handful of nodes through the
flagship's 121 to 8,192, vector and multi-column right-hand sides, and
the Newton system the Preissmann stencil itself assembles.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flowsim_tpu.ops import tridiag
from tests.test_tridiag import dense_solution, random_system

pytestmark = pytest.mark.fast


def _coupled(N, coupling=0.3):
    """Diagonally dominant system (no near-singular pivot at any N)."""
    L, D, U, b = random_system(np.random.default_rng(N), N, diag_boost=6.0)
    return L * coupling, D, U * coupling, b


@pytest.mark.parametrize("N", [7, 64, 121, 700])
def test_pcr_f64_matches_dense(N, rng):
    L, D, U, b = random_system(rng, N)
    x = tridiag.solve_block_tridiag(L, D, U, b, method="pcr")
    np.testing.assert_allclose(np.asarray(x), dense_solution(L, D, U, b),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("N", [7, 64, 121, 700])
def test_pcr_f32_matches_dense_to_f32(N, rng):
    L, D, U, b = random_system(rng, N)
    x = tridiag.solve_block_tridiag(L, D, U, b, method="pcr_f32")
    assert x.dtype == b.dtype  # cast back to the caller's precision
    np.testing.assert_allclose(np.asarray(x), dense_solution(L, D, U, b),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("N", [256, 1000, 4096, 8192])
def test_pcr_long_reach_matches_thomas(N):
    L, D, U, b = _coupled(N)
    x_t = np.asarray(tridiag.block_thomas(L, D, U, b))
    x_p = np.asarray(tridiag.block_pcr(L, D, U, b))
    scale = np.abs(x_t).max()
    assert np.abs(x_p - x_t).max() < 1e-12 * scale
    x_f = np.asarray(tridiag.solve_block_tridiag(L, D, U, b, method="pcr_f32"))
    assert np.abs(x_f - x_t).max() < 5e-6 * scale


@pytest.mark.parametrize("method", ["pcr", "pcr_f32"])
@pytest.mark.parametrize("m", [1, 3, 5])
def test_multi_rhs_columns(method, m, rng):
    L, D, U, _ = random_system(rng, 121)
    B = jnp.asarray(rng.normal(size=(121, 2, m)))
    X = np.asarray(tridiag.solve_block_tridiag(L, D, U, B, method=method))
    assert X.shape == (121, 2, m)
    tol = 1e-10 if method == "pcr" else 2e-4
    for j in range(m):
        np.testing.assert_allclose(X[..., j],
                                   dense_solution(L, D, U, B[..., j]),
                                   rtol=tol * 10, atol=tol)


@pytest.mark.parametrize("method", ["pcr", "pcr_f32"])
def test_batched_leading_axes(method, rng):
    L, D, U, b = random_system(rng, 64, batch=(3,))
    x = np.asarray(tridiag.solve_block_tridiag(L, D, U, b, method=method))
    tol = 1e-10 if method == "pcr" else 2e-4
    for i in range(3):
        np.testing.assert_allclose(x[i], dense_solution(L[i], D[i], U[i], b[i]),
                                   rtol=tol * 10, atol=tol)


@pytest.mark.parametrize("method", ["pcr", "pcr_f32"])
def test_on_preissmann_long_reach_system(method):
    """Realistic conditioning: the Newton system of a 2,048-node reach."""
    from flowsim_tpu.models import long_reach
    from flowsim_tpu.ops import preissmann as prs

    geo, us, ds, h0, Q0, sset = long_reach.build(2048, levels=2)
    prev = prs.prev_level_state(geo, h0, Q0)
    L, D, U, b, *_ = prs.assemble(geo, us, ds, sset, prev, h0, Q0,
                                  jnp.asarray(1), jnp.asarray(jnp.nan), None)
    x_t = np.asarray(tridiag.block_thomas(L, D, U, b))
    x = np.asarray(tridiag.solve_block_tridiag(L, D, U, b, method=method))
    rel = np.abs(x - x_t).max() / (np.abs(x_t).max() + 1e-30)
    assert rel < (1e-9 if method == "pcr" else 1e-4), rel
