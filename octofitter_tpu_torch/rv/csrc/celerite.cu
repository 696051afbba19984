// The celerite Gaussian-process log-likelihood and its gradient for Hopper
// (sm_90a), one tile of rows (chains) per block, with a plain C interface for
// ctypes. The step arithmetic lives in `celerite.cuh`, which the CPU tests
// also build for the host.
//
// Replaces: the two `lax.scan`s of `octofitter_tpu/rv/celerite.py:111-173`
// (`_celerite_factor_scan` and the solve in `celerite_loglike`), which the
// JAX package vmaps over chains; there is no Pallas kernel behind them.
// Eager PyTorch would launch ~19 small ops per epoch, and autograd about
// twice that again: ~4,500 launches per evaluation at 80 epochs. Here one
// forward and one backward launch do the whole evaluation.
//
// What bounds it on an H100. At many rows (2^17 x 80 epochs), bytes: the
// function reads y and var (2 words per row and epoch) once and does
// O(J^2) arithmetic per word; the bound is those bytes at 3.35 TB/s. At few
// long rows (8 x 2048), latency: each row's epochs are one dependent chain.
//
// The design against each:
// - A block of 128 threads takes R consecutive rows (a tile), one
//   recursion thread per row. R starts at 16, so that 4096 rows fill 256
//   blocks on the 132 SMs, and doubles up to 128 while there are still two
//   blocks for every SM and the block's shared memory stays within a
//   budget: at many rows the recursion fills whole warps and several tiles
//   share each SM.
// - The tile's y and var are R x n contiguous words in each array. They are
//   staged in shared memory by `cp.async`, in chunks of C epochs through two
//   buffers, so that chunk c + 1's copy overlaps chunk c's recursion: 16
//   bytes per copy where a 16-byte window of a row's segment is whole, one
//   word per copy at the ragged ends (each row keeps its words at their
//   global offset within a window, so rows that do not start 16-byte aligned
//   still copy whole windows); consecutive threads copy consecutive windows.
// - Before each chunk's sequential pass all threads of the block compute
//   every (row, epoch, term)'s phi = exp(-c dt), cos and sin of d t into
//   shared memory; the pass keeps only U and V from them, the state update,
//   S U, one reciprocal and the f and z updates, and reads each epoch's
//   words one epoch ahead.
// - The chunk length C is the caller's: long chunks (fewer barriers and
//   phases) where there are few rows and latency bounds the kernel, short
//   ones where there are many, so that more rows' chunks fit in shared
//   memory at once.
// - z^2 / D and D overwrite y and var in the buffer; with the next chunk's
//   terms, all threads sum z^2 / D and log D per row, each of a row's
//   128 / R threads over every (128 / R)-th epoch, then a fixed xor-shuffle
//   tree, chunk after chunk: the result repeats bit for bit.
// - No saved array. With a gradient the forward writes the state (packed S,
//   W, f, D, z: m(m+1)/2 + 2m + 2 words) once per C epochs per row, after
//   every chunk but the last; where n <= C it writes nothing. The backward
//   walks the chunks from last to first: it re-runs a chunk's forward from
//   its checkpoint (read into registers while the chunk's terms are
//   computed) into shared memory (D, z, W, f and packed P of every epoch),
//   walks the hand-derived adjoint in reverse over it, keeps the
//   coefficients' gradients in registers, and leaves the chunk's gradients
//   of y and var in the buffer its inputs came in, which the block stores
//   coalesced. A second forward's arithmetic is the price of reading 2
//   words per row and epoch instead of 2 + 2m + m(m+1)/2.
// - Tensor cores are not used: the state is at most 8 x 8 per row and a
//   dependent recursion over the epochs; nothing in it is a matrix product
//   that wgmma or mma.sync would take. What the card offers this kernel is
//   SMs filled with tiles, shared memory, asynchronous copies and coalesced
//   access.
//
// J (the number of terms, m = 2J) is a template parameter, 1 to 4, so every
// loop over the state unrolls into registers. C is a whole number of 16-byte
// copies of the element type.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "celerite.cuh"

namespace {

using celerite::Dims;

constexpr int kThreads = 128;  // threads per block
constexpr int kMinRows = 16, kMaxRows = 128;
constexpr int64_t kSmemBudget = 56 * 1024;  // bytes per block: four blocks fit on an SM

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // words per 16-byte copy

// A block's dynamic shared memory in words of T, for R rows and chunk length
// C: two buffers of {y, var} (row stride Cs = C + one window, so a row's
// words can sit at their global offset within a window), the chunk's terms
// [3J][C][R], the tile's coefficients [a, b, c, d][J][R], the forward's two
// sums per row, and the backward's history [2 + 2m][C + 1][R] and packed P
// [m(m+1)/2][C][R].
template <typename T, int J>
struct Plan {
  int R, C, Cs;
  int64_t terms, coef, acc, hist, hP, words;
  __host__ __device__ Plan(int R_, int C_, bool bwd) : R(R_), C(C_) {
    Cs = C + kVec<T>;
    terms = 4LL * R * Cs;
    coef = terms + (int64_t)Dims<J>::NT * C * R;
    acc = coef + 4LL * J * R;
    hist = acc + 2 * R;
    hP = hist + (bwd ? (int64_t)Dims<J>::NH * (C + 1) * R : 0);
    words = hP + (bwd ? (int64_t)Dims<J>::PK * C * R : 0);
  }
  // buffer b's array x (0: y or its gradient, 1: var or its gradient)
  __device__ T* buf(T* sm, int b, int x) const { return sm + (int64_t)(2 * b + x) * R * Cs; }
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_word(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// the position of *p within its 16-byte window, in words
template <typename T>
__device__ __forceinline__ int lead(const T* p) {
  return (int)(((uintptr_t)p % 16) / sizeof(T));
}

// log2 of the windows per row a segment of len words can touch, rounded up
// to a power of two
template <typename T>
__device__ __forceinline__ int window_shift(int len) {
  const int ns = (len + 2 * kVec<T> - 2) / kVec<T>;
  return 32 - __clz(ns - 1);
}

// Epochs [k0, k0 + len) of rows row0 .. row0 + rows - 1 of the (B, n) arrays
// x0 and x1 into the tile buffers s0 and s1: row r's epoch k0 + kk at
// s[r * Cs + lead(row's word k0) + kk]. Thread i takes 16-byte windows i,
// i + 128, ... of the rows' segments, whole windows in one copy.
template <typename T>
__device__ void stage(T* s0, T* s1, const T* x0, const T* x1, int64_t row0, int rows, int64_t n,
                      int64_t k0, int len, int Cs) {
  constexpr int V = kVec<T>;
  const int ws = window_shift<T>(len);
  for (int it = threadIdx.x; it < (2 * rows) << ws; it += kThreads) {
    const int w = it & ((1 << ws) - 1), item = it >> ws, r = item >> 1;
    const T* src = ((item & 1) ? x1 : x0) + (row0 + r) * n + k0;
    T* dst = ((item & 1) ? s1 : s0) + r * Cs + w * V;
    const int first = w * V - lead(src);  // the window's first word, in the segment
    if (first >= len) continue;
    if (first >= 0 && first + V <= len) {
      cp_async_16(dst, src + first);
    } else {
      for (int q = 0; q < V; ++q) {
        const int kk = first + q;
        if (kk >= 0 && kk < len) cp_async_word<sizeof(T)>(dst + q, src + kk);
      }
    }
  }
}

// The reverse of `stage`: the tile buffers' epochs [k0, k0 + len) to the
// (B, n) arrays x0 and x1, whole windows as one 16-byte store.
template <typename T>
__device__ void unstage(const T* s0, const T* s1, T* x0, T* x1, int64_t row0, int rows, int64_t n,
                        int64_t k0, int len, int Cs) {
  constexpr int V = kVec<T>;
  const int ws = window_shift<T>(len);
  for (int it = threadIdx.x; it < (2 * rows) << ws; it += kThreads) {
    const int w = it & ((1 << ws) - 1), item = it >> ws, r = item >> 1;
    T* dst = ((item & 1) ? x1 : x0) + (row0 + r) * n + k0;
    const T* src = ((item & 1) ? s1 : s0) + r * Cs + w * V;
    const int first = w * V - lead(dst);
    if (first >= len) continue;
    if (first >= 0 && first + V <= len) {
      *reinterpret_cast<uint4*>(dst + first) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int q = 0; q < V; ++q) {
        const int kk = first + q;
        if (kk >= 0 && kk < len) dst[kk] = src[q];
      }
    }
  }
}

// The tile's coefficients into shared memory, [a, b, c, d][J][R]
template <typename T, int J>
__device__ void load_coefficients(T* coef, const T* a, const T* b, const T* c, const T* d,
                                  int64_t row0, int rows, int R) {
  for (int i = threadIdx.x; i < rows * J; i += kThreads) {
    const int r = i / J, j = i - r * J;
    const int64_t src = (row0 + r) * J + j;
    coef[(0 * J + j) * R + r] = a[src];
    coef[(1 * J + j) * R + r] = b[src];
    coef[(2 * J + j) * R + r] = c[src];
    coef[(3 * J + j) * R + r] = d[src];
  }
}

// Every (row, epoch, term)'s terms of the chunk [k0, k0 + len), in
// parallel; lr = log2(R)
template <typename T, int J>
__device__ void terms_phase(T* terms, const T* coef, const T* __restrict__ t, int R, int lr,
                            int rows, int64_t k0, int len, int C) {
  const int items = (len * J) << lr;
  const T* tc = t + k0;
#pragma unroll 4
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int r = it & (R - 1), rest = it >> lr, j = rest % J, kk = rest / J;
    if (r >= rows) continue;
    const T tk = tc[kk];
    const T dt = k0 + kk > 0 ? tk - tc[kk - 1] : T(0);
    celerite::store_term<T, J>(coef[(2 * J + j) * R + r], coef[(3 * J + j) * R + r], tk, dt, j,
                               terms + kk * R + r, C * R);
  }
}

// z^2 / D and log D of the chunk [k0, k0 + len) summed per row into acc[r]
// and acc[R + r]: a row's G = 128 / R consecutive threads each over every
// G-th epoch, then a fixed xor-shuffle tree over the G
template <typename T>
__device__ void epilogue(T* acc, const T* sq, const T* sD, const T* y, const T* var, int64_t row0,
                         int R, int lr, int rows, int64_t n, int64_t k0, int len, int Cs) {
  const int lg = 7 - lr;  // log2(G), kThreads = 128
  const int r = threadIdx.x >> lg, s = threadIdx.x & ((1 << lg) - 1);
  T q = 0, l = 0;
  if (r < rows) {
    const int64_t at = (row0 + r) * n + k0;
    const T* qr = sq + r * Cs + lead(y + at);
    const T* Dr = sD + r * Cs + lead(var + at);
#pragma unroll 4
    for (int kk = s; kk < len; kk += 1 << lg) {
      q += qr[kk];
      l += celerite::log_t(Dr[kk]);
    }
  }
  for (int o = (1 << lg) >> 1; o > 0; o >>= 1) {
    q += __shfl_xor_sync(0xffffffffu, q, o);
    l += __shfl_xor_sync(0xffffffffu, l, o);
  }
  if (r < rows && s == 0) {
    acc[r] += q;
    acc[R + r] += l;
  }
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
celerite_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
                    const T* __restrict__ d, const T* __restrict__ t, const T* __restrict__ y,
                    const T* __restrict__ var, T* __restrict__ ll, T* __restrict__ ckpt,
                    int64_t B, int64_t n, int C, int R, int lr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Plan<T, J> pl(R, C, false);
  T *terms = sm + pl.terms, *coef = sm + pl.coef, *acc = sm + pl.acc;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int rows = B - row0 < R ? (int)(B - row0) : R;
  const int tid = threadIdx.x;
  const int nc = (int)((n + C - 1) / C);
  stage(pl.buf(sm, 0, 0), pl.buf(sm, 0, 1), y, var, row0, rows, n, 0, n < C ? (int)n : C, pl.Cs);
  cp_async_commit();
  load_coefficients<T, J>(coef, a, b, c, d, row0, rows, R);
  for (int i = tid; i < 2 * R; i += kThreads) acc[i] = 0;
  __syncthreads();
  // the recursion's thread: its row's state and coefficients
  const bool mine = tid < rows;
  const int64_t row = row0 + tid;
  celerite::State<T, J> st;
  celerite::zero_state(st);
  bool ok = true;
  T ca[J], cb[J], asum = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ca[j] = mine ? coef[j * R + tid] : T(0);
    cb[j] = mine ? coef[(J + j) * R + tid] : T(0);
    asum += ca[j];
  }
  for (int ch = 0; ch < nc; ++ch) {
    const int64_t k0 = (int64_t)ch * C;
    const int len = n - k0 < C ? (int)(n - k0) : C;
    cp_async_wait_all();
    __syncthreads();
    if (ch > 0)
      epilogue(acc, pl.buf(sm, (ch - 1) & 1, 0), pl.buf(sm, (ch - 1) & 1, 1), y, var, row0, R, lr,
               rows, n, k0 - C, C, pl.Cs);
    terms_phase<T, J>(terms, coef, t, R, lr, rows, k0, len, C);
    __syncthreads();
    if (ch + 1 < nc) {
      const int64_t k1 = k0 + C;
      stage(pl.buf(sm, (ch + 1) & 1, 0), pl.buf(sm, (ch + 1) & 1, 1), y, var, row0, rows, n, k1,
            n - k1 < C ? (int)(n - k1) : C, pl.Cs);
      cp_async_commit();
    }
    if (mine) {
      const int64_t at = row * n + k0;
      T* qs = pl.buf(sm, ch & 1, 0) + tid * pl.Cs + lead(y + at);
      T* vs = pl.buf(sm, ch & 1, 1) + tid * pl.Cs + lead(var + at);
      celerite::fwd_chunk<T, J, false>(st, ok, ca, cb, asum, terms + tid, R, C, len, qs, vs,
                                       nullptr, nullptr);
      if (ckpt && ch + 1 < nc) celerite::store_state(st, ckpt + ch * Dims<J>::NC * B + row, B);
    }
  }
  __syncthreads();
  const int64_t k_last = (int64_t)(nc - 1) * C;
  epilogue(acc, pl.buf(sm, (nc - 1) & 1, 0), pl.buf(sm, (nc - 1) & 1, 1), y, var, row0, R, lr,
           rows, n, k_last, (int)(n - k_last), pl.Cs);
  __syncthreads();
  if (mine) {
    const T half_log_2pi = T(0.91893853320467274178);
    ll[row] = ok ? T(-0.5) * acc[tid] - T(0.5) * acc[R + tid] - T(n) * half_log_2pi
                 : T(-INFINITY);
  }
}

// At J <= 2 the backward's registers are capped so that four blocks fit on
// an SM (its rows in flight, not its shared memory, limit it at many rows).
template <typename T, int J>
__global__ void __launch_bounds__(kThreads, J <= 2 ? 4 : 1)
celerite_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
                    const T* __restrict__ d, const T* __restrict__ t, const T* __restrict__ y,
                    const T* __restrict__ var, const T* __restrict__ ckpt,
                    const T* __restrict__ ll, const T* __restrict__ gll, T* __restrict__ ga,
                    T* __restrict__ gb, T* __restrict__ gc, T* __restrict__ gd,
                    T* __restrict__ gy, T* __restrict__ gvar, int64_t B, int64_t n, int C, int R,
                    int lr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Plan<T, J> pl(R, C, true);
  T *terms = sm + pl.terms, *coef = sm + pl.coef;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int rows = B - row0 < R ? (int)(B - row0) : R;
  const int tid = threadIdx.x;
  const int nc = (int)((n + C - 1) / C);
  {
    const int64_t k_last = (int64_t)(nc - 1) * C;
    stage(pl.buf(sm, (nc - 1) & 1, 0), pl.buf(sm, (nc - 1) & 1, 1), y, var, row0, rows, n, k_last,
          (int)(n - k_last), pl.Cs);
    cp_async_commit();
  }
  load_coefficients<T, J>(coef, a, b, c, d, row0, rows, R);
  __syncthreads();
  const bool mine = tid < rows;
  const int64_t row = row0 + tid;
  const bool ok = mine && !(ll[row] == T(-INFINITY));
  const T g = mine ? gll[row] : T(0);
  T ca[J], cb[J], asum = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ca[j] = mine ? coef[j * R + tid] : T(0);
    cb[j] = mine ? coef[(J + j) * R + tid] : T(0);
    asum += ca[j];
  }
  celerite::Adjoint<T, J> ad;
  celerite::zero_adjoint(ad);
  celerite::State<T, J> st;
  T* hist = sm + pl.hist + tid;
  T* hP = sm + pl.hP + tid;
  for (int ch = nc - 1; ch >= 0; --ch) {
    const int64_t k0 = (int64_t)ch * C;
    const int len = n - k0 < C ? (int)(n - k0) : C;
    // the chunk's checkpoint, in flight through the terms phase
    if (ok && ch > 0)
      celerite::load_state(st, ckpt + (ch - 1) * Dims<J>::NC * B + row, B);
    else
      celerite::zero_state(st);
    cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < nc) {
      const int64_t k1 = k0 + C;
      unstage(pl.buf(sm, (ch + 1) & 1, 0), pl.buf(sm, (ch + 1) & 1, 1), gy, gvar, row0, rows, n,
              k1, n - k1 < C ? (int)(n - k1) : C, pl.Cs);
    }
    terms_phase<T, J>(terms, coef, t, R, lr, rows, k0, len, C);
    __syncthreads();
    if (ch > 0) {
      stage(pl.buf(sm, (ch - 1) & 1, 0), pl.buf(sm, (ch - 1) & 1, 1), y, var, row0, rows, n,
            k0 - C, C, pl.Cs);
      cp_async_commit();
    }
    if (mine) {
      const int64_t at = row * n + k0;
      T* ys = pl.buf(sm, ch & 1, 0) + tid * pl.Cs;
      T* vs = pl.buf(sm, ch & 1, 1) + tid * pl.Cs;
      T* gys = ys + lead(gy + at);
      T* gvs = vs + lead(gvar + at);
      if (ok) {
        bool ok_again = true;
        celerite::fwd_chunk<T, J, true>(st, ok_again, ca, cb, asum, terms + tid, R, C, len,
                                        ys + lead(y + at), vs + lead(var + at), hist, hP);
        celerite::adjoint_chunk<T, J>(ad, g, ca, cb, terms + tid, R, C, len, hist, hP, t, k0, gys,
                                      gvs);
      } else {
        for (int kk = 0; kk < len; ++kk) gys[kk] = gvs[kk] = T(0);
      }
    }
  }
  __syncthreads();
  unstage(pl.buf(sm, 0, 0), pl.buf(sm, 0, 1), gy, gvar, row0, rows, n, 0, n < C ? (int)n : C,
          pl.Cs);
  if (mine) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      ga[row * J + j] = ok ? ad.gA[j] + ad.asum : T(0);
      gb[row * J + j] = ok ? ad.gB[j] : T(0);
      gc[row * J + j] = ok ? ad.gC[j] : T(0);
      gd[row * J + j] = ok ? ad.gD[j] : T(0);
    }
  }
}

// The launch shape for B rows on the current device: rows per block R (16,
// doubled up to 128 while B leaves two blocks per SM and the block's shared
// memory stays within kSmemBudget), its log2, and the number of blocks.
struct Tiles {
  int R, lr;
  unsigned blocks;
};

template <typename T, int J>
int tiles(int64_t B, int C, bool bwd, Tiles* tl) {
  int dev = 0, sms = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return err;
  int R = kMinRows;
  while (R < kMaxRows && B >= 4LL * sms * R &&
         Plan<T, J>(2 * R, C, bwd).words * (int64_t)sizeof(T) <= kSmemBudget)
    R *= 2;
  tl->R = R;
  tl->lr = 31 - __builtin_clz(R);
  tl->blocks = (unsigned)((B + R - 1) / R);
  return 0;
}

// Allows `kernel` the dynamic shared memory it is launched with beyond the
// default 48 KB. A refusal (more than a block may have) is returned and
// cleared, so that the next launch's cudaGetLastError does not report it.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) cudaGetLastError();
  return err;
}

template <typename T, int J>
int launch_fwd(const void* a, const void* b, const void* c, const void* d, const void* t,
               const void* y, const void* var, void* ll, void* ckpt, int64_t B, int64_t n, int C,
               cudaStream_t stream) {
  Tiles tl;
  if (int err = tiles<T, J>(B, C, false, &tl)) return err;
  const size_t bytes = Plan<T, J>(tl.R, C, false).words * sizeof(T);
  if (int err = allow_smem(celerite_fwd_kernel<T, J>, bytes)) return err;
  celerite_fwd_kernel<T, J><<<tl.blocks, kThreads, bytes, stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (const T*)d, (const T*)t, (const T*)y,
      (const T*)var, (T*)ll, (T*)ckpt, B, n, C, tl.R, tl.lr);
  return (int)cudaGetLastError();
}

template <typename T, int J>
int launch_bwd(const void* a, const void* b, const void* c, const void* d, const void* t,
               const void* y, const void* var, const void* ckpt, const void* ll, const void* gll,
               void* ga, void* gb, void* gc, void* gd, void* gy, void* gvar, int64_t B, int64_t n,
               int C, cudaStream_t stream) {
  Tiles tl;
  if (int err = tiles<T, J>(B, C, true, &tl)) return err;
  const size_t bytes = Plan<T, J>(tl.R, C, true).words * sizeof(T);
  if (int err = allow_smem(celerite_bwd_kernel<T, J>, bytes)) return err;
  celerite_bwd_kernel<T, J><<<tl.blocks, kThreads, bytes, stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (const T*)d, (const T*)t, (const T*)y,
      (const T*)var, (const T*)ckpt, (const T*)ll, (const T*)gll, (T*)ga, (T*)gb, (T*)gc, (T*)gd,
      (T*)gy, (T*)gvar, B, n, C, tl.R, tl.lr);
  return (int)cudaGetLastError();
}

template <typename T, int J>
int occupancy(int backward, int C, int64_t B, int* out) {
  Tiles tl;
  if (int err = tiles<T, J>(B, C, backward != 0, &tl)) return err;
  const size_t bytes = Plan<T, J>(tl.R, C, backward != 0).words * sizeof(T);
  out[0] = tl.R;
  out[1] = kThreads;
  out[2] = (int)bytes;
  if (backward) {
    if (int err = allow_smem(celerite_bwd_kernel<T, J>, bytes)) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, celerite_bwd_kernel<T, J>,
                                                              kThreads, bytes);
  }
  if (int err = allow_smem(celerite_fwd_kernel<T, J>, bytes)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, celerite_fwd_kernel<T, J>,
                                                            kThreads, bytes);
}

// C must be positive and a whole number of 16-byte windows
template <typename T>
bool valid_chunk(int C) { return C > 0 && C % kVec<T> == 0; }

template <typename T>
int dispatch_fwd(int J, const void* a, const void* b, const void* c, const void* d, const void* t,
                 const void* y, const void* var, void* ll, void* ckpt, int64_t B, int64_t n, int C,
                 void* stream) {
  if (!valid_chunk<T>(C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return launch_fwd<T, 1>(a, b, c, d, t, y, var, ll, ckpt, B, n, C, s);
    case 2: return launch_fwd<T, 2>(a, b, c, d, t, y, var, ll, ckpt, B, n, C, s);
    case 3: return launch_fwd<T, 3>(a, b, c, d, t, y, var, ll, ckpt, B, n, C, s);
    case 4: return launch_fwd<T, 4>(a, b, c, d, t, y, var, ll, ckpt, B, n, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_bwd(int J, const void* a, const void* b, const void* c, const void* d, const void* t,
                 const void* y, const void* var, const void* ckpt, const void* ll, const void* gll,
                 void* ga, void* gb, void* gc, void* gd, void* gy, void* gvar, int64_t B,
                 int64_t n, int C, void* stream) {
  if (!valid_chunk<T>(C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (J) {
    case 1: return launch_bwd<T, 1>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C, s);
    case 2: return launch_bwd<T, 2>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C, s);
    case 3: return launch_bwd<T, 3>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C, s);
    case 4: return launch_bwd<T, 4>(a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B, n, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_occupancy(int J, int backward, int C, int64_t B, int* out) {
  if (!valid_chunk<T>(C)) return (int)cudaErrorInvalidValue;
  switch (J) {
    case 1: return occupancy<T, 1>(backward, C, B, out);
    case 2: return occupancy<T, 2>(backward, C, B, out);
    case 3: return occupancy<T, 3>(backward, C, B, out);
    case 4: return occupancy<T, 4>(backward, C, B, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward: a, b, c, d (B, J); t (n,); y, var (B, n); writes ll (B,) and,
// unless ckpt is null, the (ceil(n / C) - 1, m(m+1)/2 + 2m + 2, B)
// checkpoints the backward reads (none where n <= C). J in 1..4; C > 0, a
// multiple of 4 (f32) or 2 (f64).
extern "C" int celerite_fwd_f32(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* y, const void* var, void* ll,
                                void* ckpt, int J, int64_t B, int64_t n, int C, void* stream) {
  return dispatch_fwd<float>(J, a, b, c, d, t, y, var, ll, ckpt, B, n, C, stream);
}

extern "C" int celerite_fwd_f64(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* y, const void* var, void* ll,
                                void* ckpt, int J, int64_t B, int64_t n, int C, void* stream) {
  return dispatch_fwd<double>(J, a, b, c, d, t, y, var, ll, ckpt, B, n, C, stream);
}

// Backward: the forward's inputs, its checkpoints (same C) and ll, and the
// cotangent gll (B,); writes ga, gb, gc, gd (B, J) and gy, gvar (B, n).
extern "C" int celerite_bwd_f32(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* y, const void* var, const void* ckpt,
                                const void* ll, const void* gll, void* ga, void* gb, void* gc,
                                void* gd, void* gy, void* gvar, int J, int64_t B, int64_t n, int C,
                                void* stream) {
  return dispatch_bwd<float>(J, a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B,
                             n, C, stream);
}

extern "C" int celerite_bwd_f64(const void* a, const void* b, const void* c, const void* d,
                                const void* t, const void* y, const void* var, const void* ckpt,
                                const void* ll, const void* gll, void* ga, void* gb, void* gc,
                                void* gd, void* gy, void* gvar, int J, int64_t B, int64_t n, int C,
                                void* stream) {
  return dispatch_bwd<double>(J, a, b, c, d, t, y, var, ckpt, ll, gll, ga, gb, gc, gd, gy, gvar, B,
                              n, C, stream);
}

// The launch of the forward (backward = 0) or backward kernel for B rows at
// (J, C) on the current device: out[0] rows per block, out[1] threads per
// block, out[2] dynamic shared memory per block, out[3] resident blocks per
// SM; elem_bytes 4 or 8.
extern "C" int celerite_occupancy(int J, int elem_bytes, int backward, int C, int64_t B, int* out) {
  if (elem_bytes == 4) return dispatch_occupancy<float>(J, backward, C, B, out);
  if (elem_bytes == 8) return dispatch_occupancy<double>(J, backward, C, B, out);
  return (int)cudaErrorInvalidValue;
}
