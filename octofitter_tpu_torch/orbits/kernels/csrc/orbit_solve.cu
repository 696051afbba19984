// The solved orbit of (Campbell elements, epochs), forward and backward.
//
// The TPU package has one Pallas kernel, the elementwise Kepler solve
// octofitter_tpu/orbits/pallas_kepler.py:kepler_solver_pallas
// (pl.pallas_call at :103); XLA fuses the rest of
// octofitter_tpu/orbits/elements.py:orbitsolve (_solve_common and the
// KepOrbit / VisualOrbit branch, :275-323) around it. Eager PyTorch does
// not fuse, so on this card that code was some 75 elementwise launches
// forward and twice that backward, each a round trip of a (chains, epochs)
// array through device memory. These two kernels move the kernel's
// boundary from "E of (M, e)" to "every OrbitSolution field of
// (elements, epochs)" and its adjoint, with the Kepler solve of
// kepler.cuh inside.
//
// Forward: elems (8, B) rows a, e, i, omega, Omega, tp, M, plx and epochs
// t (T,) give out (14, B, T) rows EA, nu, r, posx, posy, posz, vx, vy, vz,
// raoff, decoff, pmra, pmdec, radvel. A KepOrbit has no parallax: its plx
// row holds NaN, and so do the four sky fields.
// Backward: the cotangent g (14, B, T), EA (the forward's row 0) and the
// same inputs give gelems (8, B).
//
// What bounds them on Hopper: bytes. In float32 the forward reads
// 32 B + 4 T bytes and writes 56 B T, for about 200 arithmetic operations
// per (chain, epoch): 4 operations per byte, where the card can do 20.
// The backward reads 60 B T bytes and writes 32 B for about 250
// operations per (chain, epoch). At the sampler's 4096 chains x 12 epochs
// both move 3 MB: one launch each is the least time. What the design
// does about it:
//   - nothing but the inputs and outputs touches device memory: a thread
//     computes the per-chain constants (mean motion, sqrt(1 - e^2),
//     Thiele-Innes constants, the trigonometry of i, omega, Omega) in
//     registers from the 8 element values, which neighbouring threads
//     share through the cache;
//   - forward: one thread owns 16 bytes' worth of consecutive epochs of one
//     chain (4 in float32, 2 in float64) where T allows it, so the chain's
//     constants are computed once for them and each of the 14 rows is
//     written with one 16-byte store per thread, neighbouring threads on
//     neighbouring addresses;
//   - backward: a group of 2^k <= 32 lanes of one warp owns a chain; the
//     lanes stride over its epochs (coalesced reads of the 14 cotangent
//     rows), sweep the adjoint back in registers, and reduce over epochs
//     with a loop per lane and then a fixed xor-shuffle tree. No atomics:
//     the result is the same bits on every run.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// Plain C entry points, loaded with ctypes; each returns the launch's
// cudaGetLastError().

#include "kepler.cuh"

// Unit conversions, handed in by the caller so that they are defined once
// (octofitter_tpu_torch/constants.py).
template <typename T>
struct Units {
  T kepler_year_days;  // period [d] of a = 1 AU around 1 Msun
  T julian_year_days;  // AU/d x mas -> mas/yr
  T auday_to_ms;       // AU/d -> m/s
};

// What one chain's 8 elements give, constant over its epochs.
template <typename T>
struct Chain {
  T a, e, tp, mass, plx;
  T n;   // mean motion [rad/d]
  T sq;  // sqrt(1 - e^2)
  T si, ci, sw, cw, sO, cO;
  T A, B, F, G;  // Thiele-Innes constants of a unit orbit
};

template <typename T>
__device__ __forceinline__ Chain<T> load_chain(const T* __restrict__ elems,
                                               int64_t B, int64_t b,
                                               T kepler_year_days) {
  Chain<T> c;
  c.a = elems[0 * B + b];
  c.e = elems[1 * B + b];
  const T inc = elems[2 * B + b];
  const T omega = elems[3 * B + b];
  const T Omega = elems[4 * B + b];
  c.tp = elems[5 * B + b];
  c.mass = elems[6 * B + b];
  c.plx = elems[7 * B + b];
  const T period = sqrt(c.a * c.a * c.a / c.mass) * kepler_year_days;
  c.n = T(KEPLER_TWO_PI) / period;
  c.sq = sqrt(T(1) - c.e * c.e);
  sincos(inc, &c.si, &c.ci);
  sincos(omega, &c.sw, &c.cw);
  sincos(Omega, &c.sO, &c.cO);
  c.A = c.cO * c.cw - c.sO * c.sw * c.ci;
  c.B = c.sO * c.cw + c.cO * c.sw * c.ci;
  c.F = -c.cO * c.sw - c.sO * c.cw * c.ci;
  c.G = -c.sO * c.sw + c.cO * c.cw * c.ci;
  return c;
}

// The orbit-plane state of one (chain, epoch) for a given E.
template <typename T>
struct Plane {
  T sE, cE, f1, X, Y, Edot, VX, VY;
};

template <typename T>
__device__ __forceinline__ Plane<T> in_plane(const Chain<T>& c, T EA) {
  Plane<T> p;
  sincos(EA, &p.sE, &p.cE);
  p.f1 = T(1) - c.e * p.cE;
  p.X = c.a * (p.cE - c.e);
  p.Y = c.a * c.sq * p.sE;
  p.Edot = c.n / p.f1;  // rad/d
  p.VX = -c.a * p.sE * p.Edot;
  p.VY = c.a * c.sq * p.cE * p.Edot;
  return p;
}

constexpr int N_FIELDS = 14;
constexpr int N_ELEMS = 8;

template <typename T, int N>
__global__ void orbit_fwd_kernel(const T* __restrict__ elems,
                                 const T* __restrict__ t, T* __restrict__ out,
                                 int64_t B, int64_t nT, Units<T> u) {
  using P = Pack<T, N>;
  const int64_t packs_per_chain = nT / N;  // the launcher gives nT % N == 0
  const int64_t n_pack = B * packs_per_chain;
  const int64_t plane = B * nT;
  const int64_t stride = int64_t(blockDim.x) * gridDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n_pack;
       i += stride) {
    const int64_t b = i / packs_per_chain;
    const int64_t t0 = (i - b * packs_per_chain) * N;
    const Chain<T> c = load_chain(elems, B, b, u.kepler_year_days);
    const P tt = *reinterpret_cast<const P*>(t + t0);
    P f[N_FIELDS];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T EA = kepler_E(c.n * (tt.v[k] - c.tp), c.e);
      const Plane<T> p = in_plane(c, EA);
      const T posx = c.B * p.X + c.G * p.Y;
      const T posy = c.A * p.X + c.F * p.Y;
      const T posz = c.si * (c.sw * p.X + c.cw * p.Y);
      const T vx = c.B * p.VX + c.G * p.VY;
      const T vy = c.A * p.VX + c.F * p.VY;
      const T vz = c.si * (c.sw * p.VX + c.cw * p.VY);
      f[0].v[k] = EA;
      f[1].v[k] = atan2(p.Y, p.X);
      f[2].v[k] = c.a * p.f1;
      f[3].v[k] = posx;
      f[4].v[k] = posy;
      f[5].v[k] = posz;
      f[6].v[k] = vx;
      f[7].v[k] = vy;
      f[8].v[k] = vz;
      f[9].v[k] = posx * c.plx;
      f[10].v[k] = posy * c.plx;
      f[11].v[k] = vx * c.plx * u.julian_year_days;
      f[12].v[k] = vy * c.plx * u.julian_year_days;
      f[13].v[k] = vz * u.auday_to_ms;
    }
    T* o = out + b * nT + t0;
#pragma unroll
    for (int j = 0; j < N_FIELDS; ++j) {
      *reinterpret_cast<P*>(o + j * plane) = f[j];
    }
  }
}

// `lanes` threads (a power of two, at most 32, so inside one warp) own one
// chain. With has_plx == 0 (a KepOrbit) the four sky fields are NaN
// forward and their cotangents are not read.
template <typename T>
__global__ void orbit_bwd_kernel(const T* __restrict__ elems,
                                 const T* __restrict__ t,
                                 const T* __restrict__ EA,
                                 const T* __restrict__ g,
                                 T* __restrict__ gelems, int64_t B, int64_t nT,
                                 int lanes, int has_plx, Units<T> u) {
  const int64_t gid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t b = gid / lanes;
  const int lane = int(gid - b * lanes);
  const bool valid = b < B;  // every lane of a warp reaches the shuffles
  const int64_t plane = B * nT;

  T out[N_ELEMS];
#pragma unroll
  for (int j = 0; j < N_ELEMS; ++j) out[j] = T(0);

  if (valid) {
    const Chain<T> c = load_chain(elems, B, b, u.kepler_year_days);
    // adjoints of the chain's constants, summed over this lane's epochs
    T s_a = 0, s_e = 0, s_sq = 0, s_n = 0, s_MA = 0, s_plx = 0;
    T s_A = 0, s_B = 0, s_F = 0, s_G = 0, s_si = 0, s_sw = 0, s_cw = 0;
    for (int64_t k = lane; k < nT; k += lanes) {
      const int64_t idx = b * nT + k;
      const T dt = t[k] - c.tp;
      const Plane<T> p = in_plane(c, EA[idx]);
      const T g_EA = g[idx];
      const T g_nu = g[1 * plane + idx];
      const T g_r = g[2 * plane + idx];
      T g_px = g[3 * plane + idx];
      T g_py = g[4 * plane + idx];
      const T g_pz = g[5 * plane + idx];
      T g_vx = g[6 * plane + idx];
      T g_vy = g[7 * plane + idx];
      T g_vz = g[8 * plane + idx] + g[13 * plane + idx] * u.auday_to_ms;
      if (has_plx) {
        // raoff = posx plx, decoff = posy plx, pmra = vx plx yr, pmdec too
        const T g_ra = g[9 * plane + idx];
        const T g_dec = g[10 * plane + idx];
        const T g_pmra = g[11 * plane + idx] * u.julian_year_days;
        const T g_pmdec = g[12 * plane + idx] * u.julian_year_days;
        const T posx = c.B * p.X + c.G * p.Y;
        const T posy = c.A * p.X + c.F * p.Y;
        const T vx = c.B * p.VX + c.G * p.VY;
        const T vy = c.A * p.VX + c.F * p.VY;
        s_plx += g_ra * posx + g_dec * posy + g_pmra * vx + g_pmdec * vy;
        g_px += g_ra * c.plx;
        g_py += g_dec * c.plx;
        g_vx += g_pmra * c.plx;
        g_vy += g_pmdec * c.plx;
      }
      // projections: pos = (B X + G Y, A X + F Y, si (sw X + cw Y)), v alike
      const T zs = c.si * c.sw, zc = c.si * c.cw;
      T g_X = c.B * g_px + c.A * g_py + zs * g_pz;
      T g_Y = c.G * g_px + c.F * g_py + zc * g_pz;
      const T g_VX = c.B * g_vx + c.A * g_vy + zs * g_vz;
      const T g_VY = c.G * g_vx + c.F * g_vy + zc * g_vz;
      s_A += p.X * g_py + p.VX * g_vy;
      s_B += p.X * g_px + p.VX * g_vx;
      s_F += p.Y * g_py + p.VY * g_vy;
      s_G += p.Y * g_px + p.VY * g_vx;
      s_si += g_pz * (c.sw * p.X + c.cw * p.Y) + g_vz * (c.sw * p.VX + c.cw * p.VY);
      s_sw += c.si * (g_pz * p.X + g_vz * p.VX);
      s_cw += c.si * (g_pz * p.Y + g_vz * p.VY);
      // nu = atan2(Y, X), written as autograd writes it
      const T inv_r2 = T(1) / (p.X * p.X + p.Y * p.Y);
      g_X += g_nu * -p.Y * inv_r2;
      g_Y += g_nu * p.X * inv_r2;
      // r = a f1
      s_a += g_r * p.f1;
      T g_f1 = g_r * c.a;
      // X = a (cE - e)
      s_a += g_X * (p.cE - c.e);
      T g_cE = c.a * g_X;
      s_e -= c.a * g_X;
      // Y = a sq sE
      s_a += g_Y * c.sq * p.sE;
      s_sq += g_Y * c.a * p.sE;
      T g_sE = g_Y * c.a * c.sq;
      // VX = -a sE Edot
      s_a -= g_VX * p.sE * p.Edot;
      g_sE -= g_VX * c.a * p.Edot;
      T g_Edot = -g_VX * c.a * p.sE;
      // VY = a sq cE Edot
      s_a += g_VY * c.sq * p.cE * p.Edot;
      s_sq += g_VY * c.a * p.cE * p.Edot;
      g_cE += g_VY * c.a * c.sq * p.Edot;
      g_Edot += g_VY * c.a * c.sq * p.cE;
      // Edot = n / f1
      const T inv_f1 = T(1) / p.f1;
      s_n += g_Edot * inv_f1;
      g_f1 -= g_Edot * p.Edot * inv_f1;
      // f1 = 1 - e cE
      s_e -= p.cE * g_f1;
      g_cE -= c.e * g_f1;
      // sE = sin E, cE = cos E
      const T g_E = g_EA + g_sE * p.cE - g_cE * p.sE;
      // E - e sin E = MA, implicitly: dE = (dMA + sin E de) / f1
      const T g_MA = g_E * inv_f1;
      s_e += g_MA * p.sE;
      // MA = n (t - tp)
      s_n += g_MA * dt;
      s_MA += g_MA;
    }
    // the chain's constants back to its elements
    // sq = sqrt(1 - e^2); n = 2 pi / (year sqrt(a^3 / mass))
    const T g_e = s_e - s_sq * c.e / c.sq;
    const T g_a = s_a - T(1.5) * s_n * c.n / c.a;
    const T g_mass = T(0.5) * s_n * c.n / c.mass;
    const T g_tp = -c.n * s_MA;
    // A = cO cw - sO sw ci, B = sO cw + cO sw ci,
    // F = -cO sw - sO cw ci, G = -sO sw + cO cw ci
    const T g_cw = s_cw + s_A * c.cO + s_B * c.sO - s_F * c.sO * c.ci + s_G * c.cO * c.ci;
    const T g_sw = s_sw - s_A * c.sO * c.ci + s_B * c.cO * c.ci - s_F * c.cO - s_G * c.sO;
    const T g_cO = s_A * c.cw + s_B * c.sw * c.ci - s_F * c.sw + s_G * c.cw * c.ci;
    const T g_sO = -s_A * c.sw * c.ci + s_B * c.cw - s_F * c.cw * c.ci - s_G * c.sw;
    const T g_ci = -s_A * c.sO * c.sw + s_B * c.cO * c.sw - s_F * c.sO * c.cw + s_G * c.cO * c.cw;
    out[0] = g_a;
    out[1] = g_e;
    out[2] = s_si * c.ci - g_ci * c.si;
    out[3] = g_sw * c.cw - g_cw * c.sw;
    out[4] = g_sO * c.cO - g_cO * c.sO;
    out[5] = g_tp;
    out[6] = g_mass;
    out[7] = s_plx;
  }

  // sum over the chain's lanes: a fixed tree, the same bits on every run
  for (int off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N_ELEMS; ++j) {
      out[j] += __shfl_xor_sync(0xffffffffu, out[j], off);
    }
  }
  if (valid && lane == 0) {
#pragma unroll
    for (int j = 0; j < N_ELEMS; ++j) gelems[j * B + b] = out[j];
  }
}

template <typename T>
static cudaError_t launch_fwd(const T* elems, const T* t, T* out, int64_t B,
                              int64_t nT, double kepler_year_days,
                              double julian_year_days, double auday_to_ms,
                              cudaStream_t stream) {
  if (B <= 0 || nT <= 0) return cudaSuccess;
  const Units<T> u = {T(kepler_year_days), T(julian_year_days), T(auday_to_ms)};
  constexpr int N = 16 / sizeof(T);
  const bool packed = nT % N == 0 && aligned16(t) && aligned16(out);
  const int threads = 128;
  const int64_t work = packed ? B * (nT / N) : B * nT;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // the grid-stride loop covers the rest
  if (packed) {
    orbit_fwd_kernel<T, N><<<int(blocks), threads, 0, stream>>>(elems, t, out, B, nT, u);
  } else {
    orbit_fwd_kernel<T, 1><<<int(blocks), threads, 0, stream>>>(elems, t, out, B, nT, u);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_bwd(const T* elems, const T* t, const T* EA, const T* g,
                              T* gelems, int64_t B, int64_t nT, int has_plx,
                              double kepler_year_days, double julian_year_days,
                              double auday_to_ms, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const Units<T> u = {T(kepler_year_days), T(julian_year_days), T(auday_to_ms)};
  int lanes = 1;  // the least power of two that covers the epochs, up to a warp
  while (lanes < 32 && lanes < nT) lanes *= 2;
  const int threads = 128;
  const int64_t blocks = (B * lanes + threads - 1) / threads;
  if (blocks > 2147483647) return cudaErrorInvalidConfiguration;
  orbit_bwd_kernel<T><<<int(blocks), threads, 0, stream>>>(
      elems, t, EA, g, gelems, B, nT, lanes, has_plx, u);
  return cudaGetLastError();
}

extern "C" {

int orbit_solve_fwd_f32(const float* elems, const float* t, float* out,
                        int64_t B, int64_t nT, double kepler_year_days,
                        double julian_year_days, double auday_to_ms,
                        void* stream) {
  return int(launch_fwd<float>(elems, t, out, B, nT, kepler_year_days,
                               julian_year_days, auday_to_ms,
                               static_cast<cudaStream_t>(stream)));
}

int orbit_solve_fwd_f64(const double* elems, const double* t, double* out,
                        int64_t B, int64_t nT, double kepler_year_days,
                        double julian_year_days, double auday_to_ms,
                        void* stream) {
  return int(launch_fwd<double>(elems, t, out, B, nT, kepler_year_days,
                                julian_year_days, auday_to_ms,
                                static_cast<cudaStream_t>(stream)));
}

int orbit_solve_bwd_f32(const float* elems, const float* t, const float* EA,
                        const float* g, float* gelems, int64_t B, int64_t nT,
                        int has_plx, double kepler_year_days,
                        double julian_year_days, double auday_to_ms,
                        void* stream) {
  return int(launch_bwd<float>(elems, t, EA, g, gelems, B, nT, has_plx,
                               kepler_year_days, julian_year_days, auday_to_ms,
                               static_cast<cudaStream_t>(stream)));
}

int orbit_solve_bwd_f64(const double* elems, const double* t, const double* EA,
                        const double* g, double* gelems, int64_t B, int64_t nT,
                        int has_plx, double kepler_year_days,
                        double julian_year_days, double auday_to_ms,
                        void* stream) {
  return int(launch_bwd<double>(elems, t, EA, g, gelems, B, nT, has_plx,
                                kepler_year_days, julian_year_days, auday_to_ms,
                                static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
