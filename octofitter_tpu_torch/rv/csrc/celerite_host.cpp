// The celerite kernels' schedule on the host, for the CPU tests: the same
// chunks of C epochs, checkpoints and recomputation as `celerite.cu`, one row
// at a time, with the arithmetic of `celerite.cuh`. No GPU, no CUDA toolkit:
//
//     g++ -std=c++17 -O2 -shared -fPIC -o libcelerite_host.so celerite_host.cpp
//
// The entry points take and fill the arrays of `celerite.cu`'s entry points,
// float64, with the chunk length C (any C >= 1 here).

#include <math.h>
#include <stdint.h>

#include <vector>

#include "celerite.cuh"

namespace {

using celerite::Dims;

// the chunk's terms of one row, [3J][C] (the kernels' layout with one row)
template <int J>
void chunk_terms(const double* c, const double* d, const double* t, int64_t k0, int len, int C,
                 double* terms) {
  for (int kk = 0; kk < len; ++kk) {
    const int64_t k = k0 + kk;
    const double dt = k > 0 ? t[k] - t[k - 1] : 0.0;
    for (int j = 0; j < J; ++j)
      celerite::store_term<double, J>(c[j], d[j], t[k], dt, j, terms + kk, C);
  }
}

template <int J>
void forward(const double* a, const double* b, const double* c, const double* d, const double* t,
             const double* y, const double* var, double* ll, double* ckpt, int64_t B, int64_t n,
             int C) {
  const int64_t nc = (n + C - 1) / C;
  std::vector<double> terms(Dims<J>::NT * C), ys(C), vs(C);
  for (int64_t row = 0; row < B; ++row) {
    const double *ar = a + row * J, *br = b + row * J, *cr = c + row * J, *dr = d + row * J;
    double asum = 0;
    for (int j = 0; j < J; ++j) asum += ar[j];
    celerite::State<double, J> st;
    celerite::zero_state(st);
    bool ok = true;
    double quad = 0, logdet = 0;
    for (int64_t ch = 0; ch < nc; ++ch) {
      const int64_t k0 = ch * C;
      const int len = (int)(n - k0 < C ? n - k0 : C);
      chunk_terms<J>(cr, dr, t, k0, len, C, terms.data());
      for (int kk = 0; kk < len; ++kk) {
        ys[kk] = y[row * n + k0 + kk];
        vs[kk] = var[row * n + k0 + kk];
      }
      celerite::fwd_chunk<double, J, false>(st, ok, ar, br, asum, terms.data(), 1, C, len,
                                            ys.data(), vs.data(), nullptr, nullptr);
      for (int kk = 0; kk < len; ++kk) {  // z^2 / D and D
        quad += ys[kk];
        logdet += log(vs[kk]);
      }
      if (ckpt && ch + 1 < nc) celerite::store_state(st, ckpt + ch * Dims<J>::NC * B + row, B);
    }
    ll[row] = ok ? -0.5 * quad - 0.5 * logdet - 0.91893853320467274178 * (double)n : -INFINITY;
  }
}

template <int J>
void backward(const double* a, const double* b, const double* c, const double* d,
              const double* t, const double* y, const double* var, const double* ckpt,
              const double* ll, const double* gll, double* ga, double* gb, double* gc,
              double* gd, double* gy, double* gvar, int64_t B, int64_t n, int C) {
  using Dm = Dims<J>;
  const int64_t nc = (n + C - 1) / C;
  std::vector<double> terms(Dm::NT * C), ys(C), vs(C), hist(Dm::NH * (C + 1)), hP(Dm::PK * C);
  for (int64_t row = 0; row < B; ++row) {
    const double *ar = a + row * J, *br = b + row * J, *cr = c + row * J, *dr = d + row * J;
    const bool ok = !(ll[row] == -INFINITY);
    double asum = 0;
    for (int j = 0; j < J; ++j) asum += ar[j];
    celerite::Adjoint<double, J> ad;
    celerite::zero_adjoint(ad);
    for (int64_t ch = nc - 1; ch >= 0; --ch) {
      const int64_t k0 = ch * C;
      const int len = (int)(n - k0 < C ? n - k0 : C);
      double* gyr = gy + row * n + k0;
      double* gvr = gvar + row * n + k0;
      if (!ok) {
        for (int kk = 0; kk < len; ++kk) gyr[kk] = gvr[kk] = 0;
        continue;
      }
      celerite::State<double, J> st;
      if (ch > 0)
        celerite::load_state(st, ckpt + (ch - 1) * Dm::NC * B + row, B);
      else
        celerite::zero_state(st);
      chunk_terms<J>(cr, dr, t, k0, len, C, terms.data());
      for (int kk = 0; kk < len; ++kk) {
        ys[kk] = y[row * n + k0 + kk];
        vs[kk] = var[row * n + k0 + kk];
      }
      bool ok_again = true;
      celerite::fwd_chunk<double, J, true>(st, ok_again, ar, br, asum, terms.data(), 1, C, len,
                                           ys.data(), vs.data(), hist.data(), hP.data());
      celerite::adjoint_chunk<double, J>(ad, gll[row], ar, br, terms.data(), 1, C, len,
                                         hist.data(), hP.data(), t, k0, gyr, gvr);
    }
    for (int j = 0; j < J; ++j) {
      ga[row * J + j] = ok ? ad.gA[j] + ad.asum : 0.0;
      gb[row * J + j] = ok ? ad.gB[j] : 0.0;
      gc[row * J + j] = ok ? ad.gC[j] : 0.0;
      gd[row * J + j] = ok ? ad.gD[j] : 0.0;
    }
  }
}

}  // namespace

extern "C" int celerite_host_checkpoint_words(int J) {
  switch (J) {
    case 1: return Dims<1>::NC;
    case 2: return Dims<2>::NC;
    case 3: return Dims<3>::NC;
    case 4: return Dims<4>::NC;
    default: return -1;
  }
}

// Forward: a, b, c, d (B, J); t (n,); y, var (B, n); writes ll (B,) and,
// unless ckpt is null, the (ceil(n / C) - 1, checkpoint words, B) checkpoints.
extern "C" int celerite_host_fwd_f64(const double* a, const double* b, const double* c,
                                     const double* d, const double* t, const double* y,
                                     const double* var, double* ll, double* ckpt, int J, int64_t B,
                                     int64_t n, int C) {
  if (C < 1) return 1;
  switch (J) {
    case 1: forward<1>(a, b, c, d, t, y, var, ll, ckpt, B, n, C); return 0;
    case 2: forward<2>(a, b, c, d, t, y, var, ll, ckpt, B, n, C); return 0;
    case 3: forward<3>(a, b, c, d, t, y, var, ll, ckpt, B, n, C); return 0;
    case 4: forward<4>(a, b, c, d, t, y, var, ll, ckpt, B, n, C); return 0;
    default: return 1;
  }
}

// Backward: the forward's inputs, its checkpoints and ll, and the cotangent
// gll (B,); writes ga, gb, gc, gd (B, J) and gy, gvar (B, n).
extern "C" int celerite_host_bwd_f64(const double* a, const double* b, const double* c,
                                     const double* d, const double* t, const double* y,
                                     const double* var, const double* ckpt, const double* ll,
                                     const double* gll, double* ga, double* gb, double* gc,
                                     double* gd, double* gy, double* gvar, int J, int64_t B,
                                     int64_t n, int C) {
  if (C < 1) return 1;
  switch (J) {
    case 1: backward<1>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C); return 0;
    case 2: backward<2>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C); return 0;
    case 3: backward<3>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C); return 0;
    case 4: backward<4>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C); return 0;
    default: return 1;
  }
}
