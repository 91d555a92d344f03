/* flowsim_tpu native runtime components.
 *
 * The reference's only native-performance pieces are SciPy's sparse LU and
 * brentq (SURVEY.md §2 preamble).  flowsim_tpu keeps the device compute path in
 * JAX/XLA and implements the host-runtime hot spots natively:
 *
 *  - polyline_tables: rasterize an irregular cross-section polyline into
 *    monotone lookup tables (A, P, T) over a depth grid.  This is the
 *    geometry-preprocessing inner loop (ref IrregularSection.properties,
 *    cross_section.py:247-329) evaluated n_nodes x n_samples times at model
 *    build; the Python loop dominates setup time for large reaches.
 *  - block_thomas_f64: sequential 2x2-block tridiagonal LU solve, the CPU
 *    fallback / oracle for the device PCR solver.
 *  - bisect_brentq_like: robust scalar root bracketing (bisection with an
 *    secant acceleration), the native replacement for scipy.optimize.brentq
 *    in host-side preprocessing loops.
 *
 * Build: cc -O3 -march=native -shared -fPIC -o libflowsim_native.so flowsim_native.c -lm
 */

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* ----------------------------------------------------------------------- */
/* Polyline rasterization                                                   */
/* ----------------------------------------------------------------------- */

/* Wetted properties of a sorted polyline (x[i], z[i]) at water level hw.
 * Contiguous wetted runs (hw - z > 0) are integrated with water-surface
 * intersection points inserted at both ends, exactly like the reference
 * algorithm (ref cross_section.py:269-329). */
static void polyline_props_at(const double *x, const double *z, int64_t n,
                              double hw, double *A_out, double *P_out,
                              double *T_out) {
  double A = 0.0, P = 0.0, T = 0.0;
  int64_t i = 0;
  while (i < n) {
    if (hw - z[i] > 0.0) {
      int64_t start = i;
      while (i + 1 < n && hw - z[i + 1] > 0.0) i++;
      int64_t end = i;

      double x_first = x[start], z_first = z[start];
      double x_last = x[end], z_last = z[end];
      double xl = x_first, xr = x_last;
      double prev_d, prev_x;

      /* left intersection */
      if (start > 0 && z[start - 1] > hw) {
        double t = (hw - z[start - 1]) / (z[start] - z[start - 1]);
        xl = x[start - 1] + t * (x[start] - x[start - 1]);
        double dx = x_first - xl, dz = z_first - hw;
        A += 0.5 * (0.0 + (hw - z_first)) * dx;
        P += sqrt(dx * dx + dz * dz);
      }
      /* interior segments */
      prev_d = hw - z[start];
      prev_x = x[start];
      for (int64_t j = start + 1; j <= end; ++j) {
        double d = hw - z[j];
        double dx = x[j] - prev_x;
        double dz = z[j] - z[j - 1];
        A += 0.5 * (prev_d + d) * dx;
        P += sqrt(dx * dx + dz * dz);
        prev_d = d;
        prev_x = x[j];
      }
      /* right intersection */
      if (end < n - 1 && z[end + 1] > hw) {
        double t = (hw - z[end]) / (z[end + 1] - z[end]);
        xr = x[end] + t * (x[end + 1] - x[end]);
        double dx = xr - x_last, dz = hw - z_last;
        A += 0.5 * ((hw - z_last) + 0.0) * dx;
        P += sqrt(dx * dx + dz * dz);
      }
      T += xr - xl;
    }
    i++;
  }
  *A_out = A;
  *P_out = P;
  *T_out = T;
}

/* Rasterize one polyline over m depths: depths[j] above min(z).
 * Outputs arrays of length m. */
void polyline_tables(const double *x, const double *z, int64_t n,
                     const double *depths, int64_t m, double *A, double *P,
                     double *T) {
  double zmin = z[0];
  for (int64_t i = 1; i < n; ++i)
    if (z[i] < zmin) zmin = z[i];
  for (int64_t j = 0; j < m; ++j) {
    double hw = zmin + depths[j];
    polyline_props_at(x, z, n, hw, &A[j], &P[j], &T[j]);
  }
}

/* ----------------------------------------------------------------------- */
/* 2x2-block tridiagonal Thomas solve                                       */
/* ----------------------------------------------------------------------- */

static void inv2(const double *m, double *out) {
  double det = m[0] * m[3] - m[1] * m[2];
  double inv = 1.0 / det;
  out[0] = m[3] * inv;
  out[1] = -m[1] * inv;
  out[2] = -m[2] * inv;
  out[3] = m[0] * inv;
}

static void mm2(const double *a, const double *b, double *out) {
  out[0] = a[0] * b[0] + a[1] * b[2];
  out[1] = a[0] * b[1] + a[1] * b[3];
  out[2] = a[2] * b[0] + a[3] * b[2];
  out[3] = a[2] * b[1] + a[3] * b[3];
}

static void mv2(const double *a, const double *v, double *out) {
  out[0] = a[0] * v[0] + a[1] * v[1];
  out[1] = a[2] * v[0] + a[3] * v[1];
}

/* L, D, U: [n][4] row-major 2x2 blocks (L[0], U[n-1] ignored);
 * b: [n][2]; x: [n][2] output; work: caller-provided [n][6] scratch. */
void block_thomas_f64(int64_t n, const double *L, const double *D,
                      const double *U, const double *b, double *x,
                      double *work) {
  double Dhat[4], Dinv[4], tmp[4], tv[2];
  double *C = work;          /* [n][4] */
  double *d = work + 4 * n;  /* [n][2] */

  /* forward sweep */
  memcpy(Dhat, D, 4 * sizeof(double));
  inv2(Dhat, Dinv);
  mm2(Dinv, U, C);
  mv2(Dinv, b, d);
  for (int64_t i = 1; i < n; ++i) {
    mm2(&L[4 * i], &C[4 * (i - 1)], tmp);
    for (int k = 0; k < 4; ++k) Dhat[k] = D[4 * i + k] - tmp[k];
    inv2(Dhat, Dinv);
    mm2(Dinv, &U[4 * i], &C[4 * i]);
    mv2(&L[4 * i], &d[2 * (i - 1)], tv);
    tv[0] = b[2 * i] - tv[0];
    tv[1] = b[2 * i + 1] - tv[1];
    mv2(Dinv, tv, &d[2 * i]);
  }
  /* back substitution */
  x[2 * (n - 1)] = d[2 * (n - 1)];
  x[2 * (n - 1) + 1] = d[2 * (n - 1) + 1];
  for (int64_t i = n - 2; i >= 0; --i) {
    mv2(&C[4 * i], &x[2 * (i + 1)], tv);
    x[2 * i] = d[2 * i] - tv[0];
    x[2 * i + 1] = d[2 * i + 1] - tv[1];
  }
}

/* ----------------------------------------------------------------------- */
/* Bracketed scalar root find (bisection + secant), brentq-equivalent use   */
/* ----------------------------------------------------------------------- */

/* (a generic bisection helper lived here; it was never bound through native.py
   and silently returned an endpoint on an unbracketed interval — removed) */
