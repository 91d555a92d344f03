"""Block-tridiagonal solver correctness vs dense LU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flowsim_tpu.ops import tridiag

pytestmark = pytest.mark.fast


def random_system(rng, N, diag_boost=4.0, batch=()):
    L = rng.normal(size=batch + (N, 2, 2))
    U = rng.normal(size=batch + (N, 2, 2))
    D = rng.normal(size=batch + (N, 2, 2)) + diag_boost * np.eye(2)
    L[..., 0, :, :] = 0.0
    U[..., -1, :, :] = 0.0
    b = rng.normal(size=batch + (N, 2))
    return jnp.asarray(L), jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)


def dense_solution(L, D, U, b):
    A = np.asarray(tridiag.blocks_to_dense(L, D, U))
    x = np.linalg.solve(A, np.asarray(b).reshape(-1))
    return x.reshape(-1, 2)


@pytest.mark.parametrize("N", [2, 3, 5, 17, 64, 121, 257])
@pytest.mark.parametrize("method", ["thomas", "pcr"])
def test_matches_dense(N, method, rng):
    L, D, U, b = random_system(rng, N)
    x = tridiag.solve_block_tridiag(L, D, U, b, method=method)
    x_ref = dense_solution(L, D, U, b)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-9, atol=1e-10)


def test_thomas_pcr_agree(rng):
    L, D, U, b = random_system(rng, 121)
    xt = tridiag.solve_block_tridiag(L, D, U, b, method="thomas")
    xp = tridiag.solve_block_tridiag(L, D, U, b, method="pcr")
    np.testing.assert_allclose(np.asarray(xt), np.asarray(xp), rtol=1e-9, atol=1e-11)


def test_batched(rng):
    L, D, U, b = random_system(rng, 33, batch=(4,))
    for method in ["thomas", "pcr"]:
        x = tridiag.solve_block_tridiag(L, D, U, b, method=method)
        assert x.shape == (4, 33, 2)
        for j in range(4):
            x_ref = dense_solution(L[j], D[j], U[j], b[j])
            np.testing.assert_allclose(np.asarray(x[j]), x_ref, rtol=1e-8, atol=1e-9)


def test_vmap_and_grad(rng):
    L, D, U, b = random_system(rng, 16, batch=(3,))
    sol = jax.vmap(lambda l, d, u, bb: tridiag.block_pcr(l, d, u, bb))(L, D, U, b)
    assert sol.shape == (3, 16, 2)

    def loss(bb):
        return jnp.sum(tridiag.block_pcr(L[0], D[0], U[0], bb) ** 2)

    g = jax.grad(loss)(b[0])
    # finite-difference check on one entry
    eps = 1e-6
    bp = b[0].at[5, 1].add(eps)
    bm = b[0].at[5, 1].add(-eps)
    fd = (loss(bp) - loss(bm)) / (2 * eps)
    np.testing.assert_allclose(float(g[5, 1]), float(fd), rtol=1e-5)


def test_preissmann_like_structure(rng):
    """A Jacobian-shaped system: continuity/momentum-like magnitudes."""
    N = 121
    dt, dx, theta = 3600.0, 1000.0, 0.6
    # typical magnitudes from the gerd case
    dA_dh = rng.uniform(50.0, 500.0, N)
    QA = rng.uniform(0.5, 3.0, N)
    dSe = rng.uniform(-1e-6, 1e-6, N)
    avgA = rng.uniform(500.0, 5000.0, N - 1)

    L = np.zeros((N, 2, 2))
    D = np.zeros((N, 2, 2))
    U = np.zeros((N, 2, 2))
    # upstream BC: dU/dh=0, dU/dQ=1
    D[0, 0] = [0.0, 1.0]
    for i in range(N - 1):
        # continuity row of block i (row 1)
        D[i, 1, 0] = dA_dh[i] / (2 * dt)
        D[i, 1, 1] = -theta / dx
        U[i, 1, 0] = dA_dh[i + 1] / (2 * dt)
        U[i, 1, 1] = theta / dx
        # momentum row of block i+1 (row 0)
        g = 9.80665
        L_blk = np.zeros((2, 2))
        L_blk[0, 0] = (theta / dx) * QA[i] ** 2 * dA_dh[i] + g * avgA[i] * (
            -theta / dx + 0.5 * theta * dSe[i] * dA_dh[i]
        )
        L_blk[0, 1] = 1 / (2 * dt) - (theta / dx) * 2 * QA[i]
        if i + 1 < N:
            L[i + 1] = L_blk
            D[i + 1, 0, 0] = -(theta / dx) * QA[i + 1] ** 2 * dA_dh[i + 1] + g * avgA[i] * (
                theta / dx + 0.5 * theta * dSe[i + 1] * dA_dh[i + 1]
            )
            D[i + 1, 0, 1] = 1 / (2 * dt) + (theta / dx) * 2 * QA[i + 1]
    # downstream BC: rating-curve-like dD/dh=-dQdz, dD/dQ=1
    D[N - 1, 1] = [-rng.uniform(500, 3000), 1.0]

    b = rng.normal(size=(N, 2)) * 1e-3
    Lj, Dj, Uj, bj = map(jnp.asarray, (L, D, U, b))
    x_ref = dense_solution(Lj, Dj, Uj, bj)
    for method in ["thomas", "pcr"]:
        x = tridiag.solve_block_tridiag(Lj, Dj, Uj, bj, method=method)
        np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("method", ["thomas", "pcr"])
def test_spike_five_column_rhs(method, rng):
    """The SPIKE local solve: residual + two 2x2 spike blocks as one
    5-column right-hand side (parallel/domain.py _spike_solve)."""
    L, D, U, b = random_system(rng, 40)
    EV = jnp.zeros_like(L).at[0].set(L[0])
    EW = jnp.zeros_like(U).at[-1].set(U[-1])
    B = jnp.concatenate([b[..., None], EV, EW], axis=-1)  # [N, 2, 5]
    X = tridiag.solve_block_tridiag(L, D, U, B, method=method)
    assert X.shape == (40, 2, 5)
    for m in range(5):
        np.testing.assert_allclose(
            np.asarray(X[..., m]), dense_solution(L, D, U, B[..., m]), rtol=1e-9, atol=1e-10
        )


def test_dense_block_thomas_reduced_system(rng):
    """The 4x4-block Thomas of the SPIKE reduced system vs a dense solve."""
    S, m = 6, 4
    L = jnp.asarray(rng.normal(size=(S, m, m)) * 0.3).at[0].set(0.0)
    U = jnp.asarray(rng.normal(size=(S, m, m)) * 0.3).at[-1].set(0.0)
    D = jnp.asarray(rng.normal(size=(S, m, m)) + 4 * np.eye(m))
    b = jnp.asarray(rng.normal(size=(S, m)))
    A = np.zeros((S * m, S * m))
    for i in range(S):
        A[i * m:(i + 1) * m, i * m:(i + 1) * m] = D[i]
        if i:
            A[i * m:(i + 1) * m, (i - 1) * m:i * m] = L[i]
        if i < S - 1:
            A[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = U[i]
    x = tridiag.dense_block_thomas(L, D, U, b)
    np.testing.assert_allclose(np.asarray(x).reshape(-1),
                               np.linalg.solve(A, np.asarray(b).reshape(-1)),
                               rtol=1e-9, atol=1e-11)


def test_pcr_f32_inexact_newton_converges():
    """The f32 inner solve keeps the f64 Newton's convergence behavior."""
    from tests.test_preissmann_parity import run_ours_akbari

    a = run_ours_akbari(1e-8)
    b = run_ours_akbari(1e-8, linear_solver="pcr_f32")
    np.testing.assert_array_equal(np.asarray(a.output.iterations), np.asarray(b.output.iterations))
    np.testing.assert_allclose(a.depth, b.depth, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("method", ["thomas", "pcr", "pcr_f32"])
def test_multi_rhs_matches_column_solves(method, rng):
    """[N, 2, m] multi-RHS: one shared reduction, column-identical results."""
    L, D, U, _ = random_system(rng, 47)
    m = 3
    B = jnp.asarray(rng.normal(size=(47, 2, m)))
    X = tridiag.solve_block_tridiag(L, D, U, B, method=method)
    assert X.shape == (47, 2, m)
    tol = dict(rtol=1e-4, atol=1e-5) if method == "pcr_f32" else dict(rtol=1e-9, atol=1e-10)
    for j in range(m):
        xj = tridiag.solve_block_tridiag(L, D, U, B[..., j], method=method)
        np.testing.assert_allclose(np.asarray(X[..., j]), np.asarray(xj), rtol=0, atol=0)
        x_ref = dense_solution(L, D, U, B[..., j])
        np.testing.assert_allclose(np.asarray(X[..., j]), x_ref, **tol)


def test_multi_rhs_batched(rng):
    L, D, U, _ = random_system(rng, 19, batch=(2,))
    B = jnp.asarray(rng.normal(size=(2, 19, 2, 4)))
    X = tridiag.solve_block_tridiag(L, D, U, B, method="pcr")
    assert X.shape == (2, 19, 2, 4)
    for i in range(2):
        for j in range(4):
            x_ref = dense_solution(L[i], D[i], U[i], B[i, ..., j])
            np.testing.assert_allclose(np.asarray(X[i, ..., j]), x_ref,
                                       rtol=1e-8, atol=1e-9)
