// The celerite Gaussian-process log-likelihood and its gradient, one
// thread per row (chain), for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces: the two `lax.scan`s of `octofitter_tpu/rv/celerite.py:111-173`
// (`_celerite_factor_scan` and the solve in `celerite_loglike`), which the
// JAX package vmaps over chains; there is no Pallas kernel behind them.
// Eager PyTorch would launch ~19 small ops per epoch, and autograd about
// twice that again: ~4,500 launches per evaluation at 80 epochs. Here one
// forward and one backward launch do the whole evaluation.
//
// Per epoch k, with m = 2J, phi_k = exp(-c dt_k) (twice), U_k = [a cos(d t_k)
// + b sin(d t_k), a sin(d t_k) - b cos(d t_k)], V_k = [cos(d t_k), sin(d t_k)]:
//
//   P_k = S_{k-1} + D_{k-1} W_{k-1} W_{k-1}^T       S_k = phi_k phi_k^T o P_k
//   D_k = var_k + sum(a) - U_k . S_k U_k            W_k = (V_k - S_k U_k) / D_k
//   f_k = phi_k o (f_{k-1} + W_{k-1} z_{k-1})       z_k = y_k - U_k . f_k
//   ll  = -sum(z^2 / D)/2 - sum(log D)/2 - n log(2 pi)/2
//
// the plain version of `octofitter_tpu_torch/rv/celerite.py:_celerite_plain`
// in the same order. A row with any D_k that is not positive gets ll = -inf
// and a zero gradient row (selected, not multiplied); from that epoch on its
// recursion carries D = 1 and W = 0, so its state decays and stays finite.
//
// The forward saves, per epoch, D_k, z_k, W_k, f_k and the symmetric P_k
// (packed, m(m+1)/2 entries) in an (n, F, B) array, F = 2 + 2m + m(m+1)/2,
// so that consecutive threads write consecutive addresses. The backward is
// the adjoint of the recursion, derived by hand and walked in reverse: it
// recomputes phi, U and V from t and the coefficients, carries the adjoints
// of S (kept symmetric: S enters only through S U and the next P, which see
// its symmetric part), W, D, f and z, and sums the coefficients' gradients
// over the epochs (Foreman-Mackey 2018, RNAAS 2, 31, gives an O(N J^2)
// reverse pass of the same kind). It writes the gradients with respect to
// a, b, c, d (B, J), y and var (B, n); the epochs take no gradient.
//
// Bound on an H100: bytes. A thread does O(n J^2) arithmetic on O(n) inputs
// read once, and the state lives in registers (J is a template parameter,
// 1 to 4, so every loop over the state unrolls); the saved array is the
// largest traffic, written once by the forward and read once by the
// backward. Simple first: a row's inputs y[row, k] are n apart, so a warp's
// loads are not coalesced; L1 serves the next epochs of each 32-byte sector.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

// index of (i, j) in a packed symmetric m x m matrix (upper triangle, rows)
template <int M>
__device__ __forceinline__ constexpr int sym(int i, int j) {
  return i <= j ? i * M - i * (i - 1) / 2 + (j - i) : j * M - j * (j - 1) / 2 + (i - j);
}

template <int J>
struct Layout {
  static constexpr int M = 2 * J;
  static constexpr int PK = M * (M + 1) / 2;
  static constexpr int F = 2 + 2 * M + PK;  // D, z, W[M], f[M], P[PK]
  static constexpr int W0 = 2, F0 = 2 + M, P0 = 2 + 2 * M;
};

// phi, U and V of one epoch
template <typename T, int J>
__device__ __forceinline__ void epoch_terms(const T* ca, const T* cb, const T* cc, const T* cd,
                                            T tk, T dt, T* p, T* u, T* v) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T e = exp_t(-cc[j] * dt);
    T s, co;
    sin_cos(cd[j] * tk, &s, &co);
    p[j] = e;
    p[j + J] = e;
    u[j] = ca[j] * co + cb[j] * s;
    u[j + J] = ca[j] * s - cb[j] * co;
    v[j] = co;
    v[j + J] = s;
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
celerite_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
                    const T* __restrict__ d, const T* __restrict__ t, const T* __restrict__ y,
                    const T* __restrict__ var, T* __restrict__ ll, T* __restrict__ save,
                    int64_t B, int64_t n) {
  using L = Layout<J>;
  constexpr int M = L::M;
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= B) return;
  T ca[J], cb[J], cc[J], cd[J];
  T asum = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ca[j] = a[row * J + j];
    cb[j] = b[row * J + j];
    cc[j] = c[row * J + j];
    cd[j] = d[row * J + j];
    asum += ca[j];
  }
  T S[L::PK], W[M], f[M];
#pragma unroll
  for (int i = 0; i < L::PK; ++i) S[i] = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) W[i] = f[i] = 0;
  T D_prev = 0, z_prev = 0, quad = 0, logdet = 0;
  bool ok = true;
  T t_prev = t[0];
  const T* yr = y + row * n;
  const T* vr = var + row * n;
  for (int64_t k = 0; k < n; ++k) {
    const T tk = t[k];
    T p[M], u[M], v[M];
    epoch_terms<T, J>(ca, cb, cc, cd, tk, tk - t_prev, p, u, v);
    t_prev = tk;
    T* sv = save ? save + k * L::F * B + row : nullptr;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int jj = i; jj < M; ++jj) {
        const int q = sym<M>(i, jj);
        const T P = S[q] + D_prev * W[i] * W[jj];
        if (sv) sv[(L::P0 + q) * B] = P;
        S[q] = p[i] * p[jj] * P;
      }
    }
    T s[M];
    T uSu = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = 0;
#pragma unroll
      for (int jj = 0; jj < M; ++jj) acc += S[sym<M>(i, jj)] * u[jj];
      s[i] = acc;
      uSu += u[i] * acc;
    }
    const T D = (vr[k] + asum) - uSu;
    T uf = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      f[i] = p[i] * (f[i] + W[i] * z_prev);
      uf += u[i] * f[i];
    }
    const T z = yr[k] - uf;
    ok = ok && D > 0;
    const T Ds = ok ? D : T(1);
#pragma unroll
    for (int i = 0; i < M; ++i) W[i] = ok ? (v[i] - s[i]) / Ds : T(0);
    quad += z * z / Ds;
    logdet += log_t(Ds);
    if (sv) {
      sv[0] = Ds;
      sv[B] = z;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        sv[(L::W0 + i) * B] = W[i];
        sv[(L::F0 + i) * B] = f[i];
      }
    }
    D_prev = Ds;
    z_prev = z;
  }
  const T half_log_2pi = T(0.91893853320467274178);
  ll[row] = ok ? T(-0.5) * quad - T(0.5) * logdet - T(n) * half_log_2pi : T(-INFINITY);
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
celerite_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
                    const T* __restrict__ d, const T* __restrict__ t, const T* __restrict__ save,
                    const T* __restrict__ ll, const T* __restrict__ gll, T* __restrict__ ga,
                    T* __restrict__ gb, T* __restrict__ gc, T* __restrict__ gd,
                    T* __restrict__ gy, T* __restrict__ gvar, int64_t B, int64_t n) {
  using L = Layout<J>;
  constexpr int M = L::M;
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= B) return;
  T ca[J], cb[J], cc[J], cd[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ca[j] = a[row * J + j];
    cb[j] = b[row * J + j];
    cc[j] = c[row * J + j];
    cd[j] = d[row * J + j];
  }
  const bool ok = !(ll[row] == T(-INFINITY));
  const T g = gll[row];
  T gA[J], gB[J], gC[J], gD[J];
#pragma unroll
  for (int j = 0; j < J; ++j) gA[j] = gB[j] = gC[j] = gD[j] = 0;
  T g_asum = 0;
  // adjoints of the state after epoch k: S_k (symmetric part), W_k, f_k,
  // and what epoch k + 1 passed back to D_k and z_k
  T Sb[L::PK], Wb[M], fb[M];
#pragma unroll
  for (int i = 0; i < L::PK; ++i) Sb[i] = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) Wb[i] = fb[i] = 0;
  T D_acc = 0, z_acc = 0;
  T* gyr = gy + row * n;
  T* gvr = gvar + row * n;
  for (int64_t k = n - 1; k >= 0; --k) {
    const T* sv = save + k * L::F * B + row;
    const T D = sv[0], z = sv[B];
    T Wk[M], fk[M], P[L::PK];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Wk[i] = sv[(L::W0 + i) * B];
      fk[i] = sv[(L::F0 + i) * B];
    }
#pragma unroll
    for (int q = 0; q < L::PK; ++q) P[q] = sv[(L::P0 + q) * B];
    // the state before epoch k (zero before the first)
    T Wp[M], fp[M];
    T Dp = 0, zp = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) Wp[i] = fp[i] = 0;
    if (k > 0) {
      const T* pv = sv - L::F * B;
      Dp = pv[0];
      zp = pv[B];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        Wp[i] = pv[(L::W0 + i) * B];
        fp[i] = pv[(L::F0 + i) * B];
      }
    }
    const T tk = t[k];
    const T dt = k > 0 ? tk - t[k - 1] : T(0);
    T p[M], u[M], v[M];
    epoch_terms<T, J>(ca, cb, cc, cd, tk, dt, p, u, v);
    T s[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = 0;
#pragma unroll
      for (int jj = 0; jj < M; ++jj) acc += p[i] * p[jj] * P[sym<M>(i, jj)] * u[jj];
      s[i] = acc;
    }

    // ll's own terms in z_k and D_k
    const T zb = z_acc - g * z / D;
    T Db = D_acc + g * (T(0.5) * z * z / (D * D) - T(0.5) / D);
    gyr[k] = ok ? zb : T(0);
    T ub[M], vb[M], pb[M], sb[M], gbar[M];
    // z_k = y_k - U_k . f_k
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ub[i] = -zb * fk[i];
      fb[i] -= zb * u[i];
    }
    // f_k = phi_k o g_k, g_k = f_{k-1} + W_{k-1} z_{k-1}
#pragma unroll
    for (int i = 0; i < M; ++i) {
      pb[i] = fb[i] * (fp[i] + Wp[i] * zp);
      gbar[i] = fb[i] * p[i];
    }
    // W_k = (V_k - s_k) / D_k
    T wdot = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      vb[i] = Wb[i] / D;
      sb[i] = -Wb[i] / D;
      wdot += Wb[i] * Wk[i];
    }
    Db -= wdot / D;
    // D_k = var_k + sum(a) - U_k . s_k
    gvr[k] = ok ? Db : T(0);
    g_asum += Db;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ub[i] -= Db * s[i];
      sb[i] -= Db * u[i];
    }
    // s_k = S_k U_k
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = 0;
#pragma unroll
      for (int jj = 0; jj < M; ++jj) acc += p[i] * p[jj] * P[sym<M>(i, jj)] * sb[jj];
      ub[i] += acc;
#pragma unroll
      for (int jj = i; jj < M; ++jj) Sb[sym<M>(i, jj)] += T(0.5) * (sb[i] * u[jj] + sb[jj] * u[i]);
    }
    // S_k = phi phi^T o P_k, then P_k = S_{k-1} + D_{k-1} W_{k-1} W_{k-1}^T
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = 0;
#pragma unroll
      for (int jj = 0; jj < M; ++jj) acc += Sb[sym<M>(i, jj)] * P[sym<M>(i, jj)] * p[jj];
      pb[i] += T(2) * acc;
    }
#pragma unroll
    for (int q = 0; q < L::PK; ++q) P[q] = 0;  // reused for the adjoint of P_k
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int jj = i; jj < M; ++jj) P[sym<M>(i, jj)] = p[i] * p[jj] * Sb[sym<M>(i, jj)];
    }
    T WPW = 0, zW = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = 0;
#pragma unroll
      for (int jj = 0; jj < M; ++jj) acc += P[sym<M>(i, jj)] * Wp[jj];
      WPW += Wp[i] * acc;
      zW += gbar[i] * Wp[i];
      Wb[i] = gbar[i] * zp + T(2) * Dp * acc;
      fb[i] = gbar[i];
    }
#pragma unroll
    for (int q = 0; q < L::PK; ++q) Sb[q] = P[q];
    D_acc = WPW;
    z_acc = zW;
    // the coefficients' share of epoch k
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const T co = v[j], si = v[j + J];
      gC[j] -= dt * p[j] * (pb[j] + pb[j + J]);
      gA[j] += ub[j] * co + ub[j + J] * si;
      gB[j] += ub[j] * si - ub[j + J] * co;
      gD[j] += tk * (ub[j + J] * u[j] - ub[j] * u[j + J] + vb[j + J] * v[j] - vb[j] * v[j + J]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ga[row * J + j] = ok ? gA[j] + g_asum : T(0);
    gb[row * J + j] = ok ? gB[j] : T(0);
    gc[row * J + j] = ok ? gC[j] : T(0);
    gd[row * J + j] = ok ? gD[j] : T(0);
  }
}

inline unsigned blocks_for(int64_t B) { return (unsigned)((B + kThreads - 1) / kThreads); }

template <typename T, int J>
int launch_fwd(const void* a, const void* b, const void* c, const void* d, const void* t,
               const void* y, const void* var, void* ll, void* save, int64_t B, int64_t n,
               cudaStream_t stream) {
  celerite_fwd_kernel<T, J><<<blocks_for(B), kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (const T*)d, (const T*)t, (const T*)y,
      (const T*)var, (T*)ll, (T*)save, B, n);
  return (int)cudaGetLastError();
}

template <typename T, int J>
int launch_bwd(const void* a, const void* b, const void* c, const void* d, const void* t,
               const void* save, const void* ll, const void* gll, void* ga, void* gb, void* gc,
               void* gd, void* gy, void* gvar, int64_t B, int64_t n, cudaStream_t stream) {
  celerite_bwd_kernel<T, J><<<blocks_for(B), kThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (const T*)d, (const T*)t, (const T*)save,
      (const T*)ll, (const T*)gll, (T*)ga, (T*)gb, (T*)gc, (T*)gd, (T*)gy, (T*)gvar, B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int J, const void* a, const void* b, const void* c, const void* d, const void* t,
                 const void* y, const void* var, void* ll, void* save, int64_t B, int64_t n,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return launch_fwd<T, 1>(a, b, c, d, t, y, var, ll, save, B, n, s);
    case 2: return launch_fwd<T, 2>(a, b, c, d, t, y, var, ll, save, B, n, s);
    case 3: return launch_fwd<T, 3>(a, b, c, d, t, y, var, ll, save, B, n, s);
    case 4: return launch_fwd<T, 4>(a, b, c, d, t, y, var, ll, save, B, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_bwd(int J, const void* a, const void* b, const void* c, const void* d, const void* t,
                 const void* save, const void* ll, const void* gll, void* ga, void* gb, void* gc,
                 void* gd, void* gy, void* gvar, int64_t B, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return launch_bwd<T, 1>(a, b, c, d, t, save, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, s);
    case 2: return launch_bwd<T, 2>(a, b, c, d, t, save, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, s);
    case 3: return launch_bwd<T, 3>(a, b, c, d, t, save, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, s);
    case 4: return launch_bwd<T, 4>(a, b, c, d, t, save, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward: a, b, c, d (B, J); t (n,); y, var (B, n); writes ll (B,) and,
// unless save is null, the (n, F, B) array the backward reads. J in 1..4.
extern "C" int celerite_fwd_f32(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* y, const void* var, void* ll,
                                void* save, int J, int64_t B, int64_t n, void* stream) {
  return dispatch_fwd<float>(J, a, b, c, d, t, y, var, ll, save, B, n, stream);
}

extern "C" int celerite_fwd_f64(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* y, const void* var, void* ll,
                                void* save, int J, int64_t B, int64_t n, void* stream) {
  return dispatch_fwd<double>(J, a, b, c, d, t, y, var, ll, save, B, n, stream);
}

// Backward: the forward's inputs but y and var, its saved array and ll, and
// the cotangent gll (B,); writes ga, gb, gc, gd (B, J) and gy, gvar (B, n).
extern "C" int celerite_bwd_f32(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* save, const void* ll, const void* gll,
                                void* ga, void* gb, void* gc, void* gd, void* gy, void* gvar,
                                int J, int64_t B, int64_t n, void* stream) {
  return dispatch_bwd<float>(J, a, b, c, d, t, save, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, stream);
}

extern "C" int celerite_bwd_f64(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* save, const void* ll, const void* gll,
                                void* ga, void* gb, void* gc, void* gd, void* gy, void* gvar,
                                int J, int64_t B, int64_t n, void* stream) {
  return dispatch_bwd<double>(J, a, b, c, d, t, save, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, stream);
}
