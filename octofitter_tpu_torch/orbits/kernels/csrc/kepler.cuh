// The elliptic Kepler solve E - e sin E = M for one element, as device
// functions shared by the standalone kernel (kepler.cu) and the fused
// orbit-solve kernel (orbit_solve.cu).
//
// Replaces the body of the TPU kernel octofitter_tpu/orbits/pallas_kepler.py:
// kepler_solver_pallas (_markley_block, pl.pallas_call at :103), and computes
// what octofitter_tpu/orbits/kepler.py:kepler_solver computes:
//   1. reduce M to [-pi, pi) with a floor-mod (the divisor's sign, as
//      jnp.mod and torch.remainder take it), keeping the 2 pi offset and
//      the sign of the reduced anomaly;
//   2. the Markley (1995) cubic starter;
//   3. a 5th-order correction;
//   4. one Newton polish, then restore the sign and the offset.
//
// What bounds it on Hopper: the solve moves 12 bytes per element in
// float32 (24 in float64) and does about 90 arithmetic operations, so by
// bytes and flops it is memory-bound; in practice the limit is the number
// of instructions issued, because every IEEE divide, sqrt, cbrt, fmod and
// full-range sincos expands to many. What the design does about it, with
// no fast-math and the same value computed:
//   - the range reduction is one multiply, a floor and one fma whose result
//     is exact, in place of the fmod loop; it gives the bits fmod gives
//     (fmod itself is kept for |x| >= 2^20, where the quotient would lose
//     its integer bits);
//   - divides by constants are multiplies by their reciprocals, the two
//     divides of the starter and the two of the third-order step are one
//     each (9 divides become 6), and the correction polynomials are in
//     Horner form.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KEPLER_PI 3.14159265358979323846
#define KEPLER_TWO_PI 6.28318530717958647692
#define KEPLER_INV_TWO_PI 0.15915494309189533577
#define KEPLER_PI2 9.86960440108935861883  // pi^2

// x - floor(x / y) y for y = T(2 pi): what torch.remainder(x, y) and
// jnp.mod(x, y) return.
template <typename T>
__device__ __forceinline__ T floor_mod_two_pi(T x) {
  const T y = T(KEPLER_TWO_PI);
  if (fabs(x) < T(1048576.0)) {
    // q is the quotient or one off it; x - q y is then exactly
    // representable, so the fma returns it, and one add or subtract of y
    // lands in [0, y) with the single rounding fmod-then-add would make.
    const T q = floor(x * T(KEPLER_INV_TWO_PI));
    T r = fma(-q, y, x);
    if (r < T(0)) {
      r += y;
    } else if (r >= y) {
      r -= y;
    }
    return r;
  }
  const T r = fmod(x, y);
  return (r < T(0)) ? r + y : r;
}

// Markley starter, 5th-order correction and one Newton polish for M in
// [0, pi].
template <typename T>
__device__ __forceinline__ T markley(T M, T e) {
  const T pi = T(KEPLER_PI), pi2 = T(KEPLER_PI2);
  const T ome = T(1) - e;
  const T alpha = (T(3) * pi2 + T(1.6) * pi * (pi - M) / (T(1) + e)) *
                  T(1.0 / (KEPLER_PI2 - 6.0));
  const T d = T(3) * ome + alpha * e;
  const T M2 = M * M;
  const T q = T(2) * alpha * d * ome - M2;
  const T r = T(3) * alpha * d * (d - ome) * M + M2 * M;
  const T c = cbrt(fabs(r) + sqrt(q * q * q + r * r));
  const T w = c * c;
  const T den = w * w + w * q + q * q;
  // (2 r w / den + M) / d with one divide
  const T E1 = (T(2) * r * w + M * den) / (den * d);

  T sE, cE;
  sincos(E1, &sE, &cE);
  const T f2 = e * sE;
  const T f3 = e * cE;
  const T f0 = E1 - f2 - M;
  const T f1 = T(1) - f3;
  const T h2 = T(0.5) * f2, h3 = T(1.0 / 6.0) * f3, h4 = T(-1.0 / 24.0) * f2;
  // -f0 / (f1 - f0 f2 / (2 f1)) with one divide
  const T d3 = T(-2) * f0 * f1 / (T(2) * f1 * f1 - f0 * f2);
  const T d4 = -f0 / (f1 + d3 * (h2 + d3 * h3));
  const T d5 = -f0 / (f1 + d4 * (h2 + d4 * (h3 + d4 * h4)));
  const T E = E1 + d5;
  // one Newton polish
  T sN, cN;
  sincos(E, &sN, &cN);
  return E - (E - e * sN - M) / (T(1) - e * cN);
}

// E(M, e) for any real M and 0 <= e < 1; E - M is periodic in M.
template <typename T>
__device__ __forceinline__ T kepler_E(T m, T e) {
  const T pi = T(KEPLER_PI);
  const T Mr = floor_mod_two_pi(m + pi) - pi;
  const T offset = m - Mr;
  const T E = markley(fabs(Mr), e);
  return ((Mr < T(0)) ? -E : E) + offset;
}

// N consecutive elements moved by one load or store instruction where
// sizeof(T) * N is 16 bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

static inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
