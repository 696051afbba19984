// Elliptic Kepler solve E - e sin E = M over flat arrays.
//
// Replaces the TPU kernel octofitter_tpu/orbits/pallas_kepler.py:
// kepler_solver_pallas (pl.pallas_call at :103); the solve itself is
// kepler.cuh:kepler_E, shared with the fused orbit-solve kernel.
//
// What bounds it on Hopper: 12 bytes and about 90 arithmetic operations
// per element in float32 (24 bytes in float64), so the bound is the bytes
// moved; the kernel sits above it because of the instructions it issues
// (kepler.cuh says which, and what was cut). At the sampler's 49,152
// elements (4096 chains x 12 epochs) it is launch-bound. Each thread
// takes 16 bytes of M and of e with one load each (4 float32 or 2 float64
// elements), solves them as independent instruction streams, and writes
// 16 bytes of E with one store; the ragged tail and arrays that are not
// 16-byte aligned go element by element. Two TPU workarounds of the
// Pallas kernel are gone: CUDA has a correctly rounded cbrt (the Pallas
// kernel emulated it with exp/log and a Newton step), and the ragged edge
// is masked by the loop bound instead of padding the input to (8k, 128)
// tiles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC
// Plain C entry points, loaded with ctypes; each returns the launch's
// cudaGetLastError().

#include "kepler.cuh"

template <typename T, int N>
__global__ void kepler_kernel(const T* __restrict__ M, const T* __restrict__ e,
                              T* __restrict__ E, int64_t n) {
  using P = Pack<T, N>;
  const int64_t n_pack = n / N;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(blockDim.x) * gridDim.x;
  for (int64_t i = tid; i < n_pack; i += stride) {
    const P m = reinterpret_cast<const P*>(M)[i];
    const P ecc = reinterpret_cast<const P*>(e)[i];
    P out;
#pragma unroll
    for (int k = 0; k < N; ++k) out.v[k] = kepler_E(m.v[k], ecc.v[k]);
    reinterpret_cast<P*>(E)[i] = out;
  }
  // the n % N elements after the last whole pack (fewer than N <= stride)
  const int64_t j = n_pack * N + tid;
  if (j < n) E[j] = kepler_E(M[j], e[j]);
}

template <typename T>
static cudaError_t launch(const T* M, const T* e, T* E, int64_t n,
                          cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  constexpr int N = 16 / sizeof(T);
  const bool packed = aligned16(M) && aligned16(e) && aligned16(E);
  const int threads = 256;
  // Enough blocks to fill 132 SMs several times over; the grid-stride
  // loop covers the rest.
  const int64_t work = packed ? (n + N - 1) / N : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (packed) {
    kepler_kernel<T, N><<<int(blocks), threads, 0, stream>>>(M, e, E, n);
  } else {
    kepler_kernel<T, 1><<<int(blocks), threads, 0, stream>>>(M, e, E, n);
  }
  return cudaGetLastError();
}

extern "C" {

int kepler_solve_f32(const float* M, const float* e, float* E, int64_t n,
                     void* stream) {
  return int(launch<float>(M, e, E, n, static_cast<cudaStream_t>(stream)));
}

int kepler_solve_f64(const double* M, const double* e, double* E, int64_t n,
                     void* stream) {
  return int(launch<double>(M, e, E, n, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
