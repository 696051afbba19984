// The celerite recursion's arithmetic for one row, shared by the CUDA
// kernels of `celerite.cu` and by the host build of the same schedule
// (`celerite_host.cpp`) that the CPU tests compile with g++: the epoch
// terms, the forward step, the adjoint step, the checkpoint record, and the
// walk of one chunk of epochs forward and backward.
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
// and a zero gradient row; from that epoch on its recursion carries D = 1 and
// W = 0, so its state decays and stays finite.
//
// Strided views: a chunk's terms and history lie in arrays laid out
// [field][epoch][row], so a function given a row's first word and the row
// stride `rs` reads field q of local epoch kk at [(q * len_field + kk) * rs];
// the kernels pass their tile's row count, the host build 1. These offsets
// stay within one block's shared memory (one row's chunk on the host), so
// they are 32-bit.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define CEL_FN __host__ __device__ __forceinline__
#else
#define CEL_FN inline
#endif

namespace celerite {

template <int J>
struct Dims {
  static constexpr int M = 2 * J;             // state size
  static constexpr int PK = M * (M + 1) / 2;  // a packed symmetric M x M matrix
  static constexpr int NT = 3 * J;            // terms per epoch: phi, cos(d t), sin(d t)
  static constexpr int NH = 2 + 2 * M;        // history per epoch: D, z, W (M), f (M)
  static constexpr int NC = PK + 2 * M + 2;   // checkpoint: S (PK), W (M), f (M), D, z
};

// index of (i, j) in a packed symmetric M x M matrix (upper triangle, rows)
template <int M>
CEL_FN constexpr int sym(int i, int j) {
  return i <= j ? i * M - i * (i - 1) / 2 + (j - i) : j * M - j * (j - 1) / 2 + (i - j);
}

CEL_FN float exp_t(float x) { return expf(x); }
CEL_FN double exp_t(double x) { return exp(x); }
CEL_FN float log_t(float x) { return logf(x); }
CEL_FN double log_t(double x) { return log(x); }
CEL_FN void sin_cos(float x, float* s, float* c) {
#ifdef __CUDA_ARCH__
  sincosf(x, s, c);
#else
  *s = sinf(x);
  *c = cosf(x);
#endif
}
CEL_FN void sin_cos(double x, double* s, double* c) {
#ifdef __CUDA_ARCH__
  sincos(x, s, c);
#else
  *s = ::sin(x);
  *c = ::cos(x);
#endif
}

// The state after an epoch: S (packed), W, f, and the epoch's (gated) D and z.
// It is also the checkpoint record, field q at rec[q * stride] in this order.
template <typename T, int J>
struct State {
  T S[Dims<J>::PK], W[2 * J], f[2 * J], D, z;
};

template <typename T, int J>
CEL_FN void zero_state(State<T, J>& st) {
#pragma unroll
  for (int q = 0; q < Dims<J>::PK; ++q) st.S[q] = 0;
#pragma unroll
  for (int i = 0; i < 2 * J; ++i) st.W[i] = st.f[i] = 0;
  st.D = st.z = 0;
}

template <typename T, int J>
CEL_FN void store_state(const State<T, J>& st, T* rec, int64_t stride) {
  constexpr int PK = Dims<J>::PK, M = 2 * J;
#pragma unroll
  for (int q = 0; q < PK; ++q) rec[q * stride] = st.S[q];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    rec[(PK + i) * stride] = st.W[i];
    rec[(PK + M + i) * stride] = st.f[i];
  }
  rec[(PK + 2 * M) * stride] = st.D;
  rec[(PK + 2 * M + 1) * stride] = st.z;
}

template <typename T, int J>
CEL_FN void load_state(State<T, J>& st, const T* rec, int64_t stride) {
  constexpr int PK = Dims<J>::PK, M = 2 * J;
#pragma unroll
  for (int q = 0; q < PK; ++q) st.S[q] = rec[q * stride];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    st.W[i] = rec[(PK + i) * stride];
    st.f[i] = rec[(PK + M + i) * stride];
  }
  st.D = rec[(PK + 2 * M) * stride];
  st.z = rec[(PK + 2 * M + 1) * stride];
}

// The terms of term j at one epoch (t_k, dt_k = t_k - t_{k-1}, 0 at the
// first): phi = exp(-c dt) at out[j * fs], cos(d t_k) at out[(J + j) * fs]
// and sin(d t_k) at out[(2J + j) * fs].
template <typename T, int J>
CEL_FN void store_term(T c, T d, T tk, T dt, int j, T* out, int fs) {
  T s, co;
  sin_cos(d * tk, &s, &co);
  out[j * fs] = exp_t(-c * dt);
  out[(J + j) * fs] = co;
  out[(2 * J + j) * fs] = s;
}

// One epoch's stored terms (the 3J words of `store_term`), and from them
// and a, b the step's phi, U and V (each 2J)
template <typename T, int J>
struct Terms {
  T e[J], co[J], si[J];
};

template <typename T, int J>
CEL_FN void load_terms(Terms<T, J>& tm, const T* in, int fs) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    tm.e[j] = in[j * fs];
    tm.co[j] = in[(J + j) * fs];
    tm.si[j] = in[(2 * J + j) * fs];
  }
}

template <typename T, int J>
CEL_FN void expand_terms(const Terms<T, J>& tm, const T* ca, const T* cb, T* p, T* u, T* v) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    p[j] = p[j + J] = tm.e[j];
    u[j] = ca[j] * tm.co[j] + cb[j] * tm.si[j];
    u[j + J] = ca[j] * tm.si[j] - cb[j] * tm.co[j];
    v[j] = tm.co[j];
    v[j + J] = tm.si[j];
  }
}

// One epoch forward from the state after the previous one; `ok` turns false
// at the first D_k <= 0. With P, writes the packed P_k at P[q * ps]. Returns
// 1 / D_k (gated).
template <typename T, int J>
CEL_FN T fwd_step(State<T, J>& st, bool& ok, T asum, const T* p, const T* u, const T* v, T yk,
                  T vk, T* P, int ps) {
  constexpr int M = 2 * J;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int jj = i; jj < M; ++jj) {
      const int q = sym<M>(i, jj);
      const T Pq = st.S[q] + st.D * st.W[i] * st.W[jj];
      if (P) P[q * ps] = Pq;
      st.S[q] = p[i] * p[jj] * Pq;
    }
  }
  T s[M];
  T uSu = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = 0;
#pragma unroll
    for (int jj = 0; jj < M; ++jj) acc += st.S[sym<M>(i, jj)] * u[jj];
    s[i] = acc;
    uSu += u[i] * acc;
  }
  const T D = (vk + asum) - uSu;
  T uf = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    st.f[i] = p[i] * (st.f[i] + st.W[i] * st.z);
    uf += u[i] * st.f[i];
  }
  ok = ok && D > 0;
  const T Ds = ok ? D : T(1);
  const T inv = T(1) / Ds;
#pragma unroll
  for (int i = 0; i < M; ++i) st.W[i] = ok ? (v[i] - s[i]) * inv : T(0);
  st.D = Ds;
  st.z = yk - uf;
  return inv;
}

// Epochs [0, len) of a chunk forward for one row with coefficients ca, cb
// (J each) and asum = sum(a). terms: the chunk's terms, [3J][C][rows] from
// this row's first word; ys, vs: the row's y and var of the chunk. Without
// kHist (the forward) z_k^2 / D_k and D_k overwrite y_k and var_k. With
// kHist (the backward's recomputation) D_k and z_k are kept with W_k and
// f_k in hist, [2 + 2m][C + 1][rows], slot 0 holding the state the chunk
// starts from and slot kk + 1 that after epoch kk, and P_k in hP,
// [m(m+1)/2][C][rows]; y and var are left as they are. Each epoch's words
// are read one epoch ahead, so their latency stays off the recursion.
template <typename T, int J, bool kHist>
CEL_FN void fwd_chunk(State<T, J>& st, bool& ok, const T* ca, const T* cb, T asum,
                      const T* terms, int rs, int C, int len, T* ys, T* vs, T* hist, T* hP) {
  constexpr int M = 2 * J;
  const int fs = C * rs, hs = (C + 1) * rs;
  if (kHist) {
    hist[0] = st.D;
    hist[hs] = st.z;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      hist[(2 + i) * hs] = st.W[i];
      hist[(2 + M + i) * hs] = st.f[i];
    }
  }
  Terms<T, J> next;
  T y_next = 0, v_next = 0;
  if (len > 0) {
    load_terms<T, J>(next, terms, fs);
    y_next = ys[0];
    v_next = vs[0];
  }
  for (int kk = 0; kk < len; ++kk) {
    const Terms<T, J> cur = next;
    const T yk = y_next, vk = v_next;
    if (kk + 1 < len) {
      load_terms<T, J>(next, terms + (kk + 1) * rs, fs);
      y_next = ys[kk + 1];
      v_next = vs[kk + 1];
    }
    T p[M], u[M], v[M];
    expand_terms<T, J>(cur, ca, cb, p, u, v);
    const T inv = fwd_step<T, J>(st, ok, asum, p, u, v, yk, vk,
                                 kHist ? hP + kk * rs : nullptr, fs);
    if (kHist) {
      T* h = hist + (kk + 1) * rs;
      h[0] = st.D;
      h[hs] = st.z;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        h[(2 + i) * hs] = st.W[i];
        h[(2 + M + i) * hs] = st.f[i];
      }
    } else {
      ys[kk] = st.z * st.z * inv;
      vs[kk] = st.D;
    }
  }
}

// The adjoint carried backward over the epochs: of S_k (its symmetric part:
// S enters only through S U and the next P, which see that part), W_k, f_k,
// and what epoch k + 1 passed back to D_k and z_k; and the coefficients'
// gradients summed over the epochs (asum: that of sum(a), through every D).
template <typename T, int J>
struct Adjoint {
  T Sb[Dims<J>::PK], Wb[2 * J], fb[2 * J], D, z;
  T gA[J], gB[J], gC[J], gD[J], asum;
};

template <typename T, int J>
CEL_FN void zero_adjoint(Adjoint<T, J>& ad) {
#pragma unroll
  for (int q = 0; q < Dims<J>::PK; ++q) ad.Sb[q] = 0;
#pragma unroll
  for (int i = 0; i < 2 * J; ++i) ad.Wb[i] = ad.fb[i] = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) ad.gA[j] = ad.gB[j] = ad.gC[j] = ad.gD[j] = 0;
  ad.D = ad.z = ad.asum = 0;
}

// The adjoint of epoch k (Foreman-Mackey 2018, RNAAS 2, 31, gives an
// O(N J^2) reverse pass of the same kind), derived by hand: from the epoch's
// terms, t_k and dt_k, its D, z, W, f and packed P, the state before it (Dp,
// zp, Wp, fp; zero before the first epoch) and the cotangent g of ll; returns
// the gradients of y_k and var_k in *gy and *gvar.
template <typename T, int J>
CEL_FN void adj_step(Adjoint<T, J>& ad, T g, const T* p, const T* u, const T* v, T tk, T dt, T D,
                     T z, const T* Wk, const T* fk, const T* P, T Dp, T zp, const T* Wp,
                     const T* fp, T* gy, T* gvar) {
  constexpr int M = 2 * J, PK = Dims<J>::PK;
  const T inv = T(1) / D;
  T s[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = 0;
#pragma unroll
    for (int jj = 0; jj < M; ++jj) acc += p[i] * p[jj] * P[sym<M>(i, jj)] * u[jj];
    s[i] = acc;
  }
  // ll's own terms in z_k and D_k
  const T zb = ad.z - g * z * inv;
  T Db = ad.D + g * (T(0.5) * z * z * inv * inv - T(0.5) * inv);
  *gy = zb;
  T ub[M], vb[M], pb[M], sb[M], gbar[M];
  // z_k = y_k - U_k . f_k
#pragma unroll
  for (int i = 0; i < M; ++i) {
    ub[i] = -zb * fk[i];
    ad.fb[i] -= zb * u[i];
  }
  // f_k = phi_k o g_k, g_k = f_{k-1} + W_{k-1} z_{k-1}
#pragma unroll
  for (int i = 0; i < M; ++i) {
    pb[i] = ad.fb[i] * (fp[i] + Wp[i] * zp);
    gbar[i] = ad.fb[i] * p[i];
  }
  // W_k = (V_k - s_k) / D_k
  T wdot = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    vb[i] = ad.Wb[i] * inv;
    sb[i] = -ad.Wb[i] * inv;
    wdot += ad.Wb[i] * Wk[i];
  }
  Db -= wdot * inv;
  // D_k = var_k + sum(a) - U_k . s_k
  *gvar = Db;
  ad.asum += Db;
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
    for (int jj = i; jj < M; ++jj) ad.Sb[sym<M>(i, jj)] += T(0.5) * (sb[i] * u[jj] + sb[jj] * u[i]);
  }
  // S_k = phi phi^T o P_k, then P_k = S_{k-1} + D_{k-1} W_{k-1} W_{k-1}^T
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = 0;
#pragma unroll
    for (int jj = 0; jj < M; ++jj) acc += ad.Sb[sym<M>(i, jj)] * P[sym<M>(i, jj)] * p[jj];
    pb[i] += T(2) * acc;
  }
  T Pb[PK];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int jj = i; jj < M; ++jj) Pb[sym<M>(i, jj)] = p[i] * p[jj] * ad.Sb[sym<M>(i, jj)];
  }
  T WPW = 0, zW = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = 0;
#pragma unroll
    for (int jj = 0; jj < M; ++jj) acc += Pb[sym<M>(i, jj)] * Wp[jj];
    WPW += Wp[i] * acc;
    zW += gbar[i] * Wp[i];
    ad.Wb[i] = gbar[i] * zp + T(2) * Dp * acc;
    ad.fb[i] = gbar[i];
  }
#pragma unroll
  for (int q = 0; q < PK; ++q) ad.Sb[q] = Pb[q];
  ad.D = WPW;
  ad.z = zW;
  // the coefficients' share of epoch k
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const T co = v[j], si = v[j + J];
    ad.gC[j] -= dt * p[j] * (pb[j] + pb[j + J]);
    ad.gA[j] += ub[j] * co + ub[j + J] * si;
    ad.gB[j] += ub[j] * si - ub[j + J] * co;
    ad.gD[j] += tk * (ub[j + J] * u[j] - ub[j] * u[j + J] + vb[j + J] * v[j] - vb[j] * v[j + J]);
  }
}

// Epochs len - 1 down to 0 of the chunk starting at epoch k0, backward for
// one row, from `fwd_chunk<.., true>`'s hist and hP and the chunk's terms (the
// layouts there); t: all n epochs. Writes the gradients of y_k and var_k to
// gys[kk] and gvs[kk].
template <typename T, int J>
CEL_FN void adjoint_chunk(Adjoint<T, J>& ad, T g, const T* ca, const T* cb, const T* terms, int rs,
                          int C, int len, const T* hist, const T* hP, const T* t, int64_t k0,
                          T* gys, T* gvs) {
  constexpr int M = 2 * J, PK = Dims<J>::PK;
  const int fs = C * rs, hs = (C + 1) * rs;
  const T* tc = t + k0;
  for (int kk = len - 1; kk >= 0; --kk) {
    const T tk = tc[kk];
    const T dt = k0 + kk > 0 ? tk - tc[kk - 1] : T(0);
    Terms<T, J> tm;
    load_terms<T, J>(tm, terms + kk * rs, fs);
    T p[M], u[M], v[M];
    expand_terms<T, J>(tm, ca, cb, p, u, v);
    const T* h = hist + (kk + 1) * rs;  // after epoch kk
    const T* hp = hist + kk * rs;       // before it
    T Wk[M], fk[M], Wp[M], fp[M], P[PK];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Wk[i] = h[(2 + i) * hs];
      fk[i] = h[(2 + M + i) * hs];
      Wp[i] = hp[(2 + i) * hs];
      fp[i] = hp[(2 + M + i) * hs];
    }
#pragma unroll
    for (int q = 0; q < PK; ++q) P[q] = hP[(q * C + kk) * rs];
    adj_step<T, J>(ad, g, p, u, v, tk, dt, h[0], h[hs], Wk, fk, P, hp[0], hp[hs], Wp, fp,
                   gys + kk, gvs + kk);
  }
}

}  // namespace celerite
