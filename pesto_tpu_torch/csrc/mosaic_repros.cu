// The five kernels of docs/mosaic_repros.py as CUDA for Hopper (sm_90a).
//
// On the TPU each case is a Pallas kernel that the Mosaic compiler refused
// or hung on in one of its two variants. On Hopper every variant is an
// ordinary kernel: the compiler faults have no CUDA counterpart. Each kernel
// computes the exact function of its TPU kernel, so the wrappers in
// ops/mosaic_repros.py hold it bit for bit against a plain PyTorch version.
//
//   scale_add      case_vmem500.kernel (mosaic_repros.py:56, call :64):
//                  scratch = 2x; out = scratch + 1. The TPU kernel's 20 MB
//                  VMEM scratch becomes a shared-memory tile that each block
//                  streams its part of x through. The tile is the budget the
//                  caller gives: 48 KB fits without opting in; more (up to
//                  the 227 KB a Hopper block can have) is opted in with
//                  cudaFuncSetAttribute. Bound by bytes (8 B per element).
//   rowmax_mul     case_bf16broadcast.kernel (:87, call :92):
//                  x * max(x, axis=1, keepdims), fp32 or bf16. One warp per
//                  row. The max lets a NaN win, as jnp.max does (fmaxf and
//                  __hmax drop it). The bf16 product is the fp32 product of
//                  the two bf16 values, which is exact, rounded once to
//                  bf16: the bf16 product bit for bit. Bound by bytes.
//   carry_and      case_i1carry.kernel (:109, call :123): per column,
//                  c = x[0] > 0, then c &= x[i] > 0.5 for i < n, with n read
//                  on the device (a dynamic trip count, clamped to the rows),
//                  carried as an int or as a bool. Bound by the launch.
//   bitcast_first  case_bitcast0.kernel (:147, call :157): the bits of
//                  x[0, 0] as int32, across the row; rank 0 keeps the value
//                  in a register, rank 1 goes through a one-element
//                  shared-memory vector. Bound by the launch.
//   bisect_mask    case_bisecthang.kernel (:178, call :194): per row, 16
//                  bisection steps on [0, 1e6] towards the 64th smallest
//                  value, then out = hi >= d. Each step asks whether
//                  count(d <= mid) < 64, which is exactly v64 > mid, where
//                  v64 is the row's 64th smallest non-NaN value (+inf when
//                  it has fewer than 64): a NaN is never <= mid, +inf never
//                  is and sorts last, -inf and negatives always are, -0.0
//                  and +0.0 compare equal, and a tie at mid counts the same
//                  on both sides. So the kernel finds v64 once and replays
//                  the 16 steps on it as scalar code; the mask is bit for
//                  bit the 16 counting passes'. Bound by bytes (4 B in, 1 B
//                  out per element) and built to reach it:
//                  - persistent blocks of 256 threads, three to an SM,
//                    walk over the rows; each row is read from HBM once, by
//                    one bulk copy (TMA, completing on an mbarrier; 4-byte
//                    cp.async for a misaligned head and tail) into a
//                    two-stage ring in shared memory, the next row landing
//                    while this one is worked on (one stage when two do not
//                    fit; a row past one stage's room reads its rest
//                    through L2 on each sweep);
//                  - each thread then keeps 32 neighbouring values (8192 a
//                    block) in registers, so later sweeps cost no shared
//                    memory, and writes their mask as two 16-byte streaming
//                    stores;
//                  - v64 comes without per-value atomics: each lane's least
//                    value; the 8th least of those per warp, and of those
//                    the least that 64 lanes' minima are at or under, which
//                    bounds v64 from above; the ~70 values of 8192 at or
//                    under the bound gathered at offsets from a block scan;
//                    v64 the largest of them with fewer than 64 below it,
//                    found by a rank count spread over the threads;
//                  - more than BISECT_CANDIDATES values at the bound (ties,
//                    a narrow band) hand the row to a radix select over the
//                    floats' order-preserving 32-bit keys, digits of 11, 11
//                    and 10 bits, a shared-memory histogram and a block
//                    scan for the digit that holds the 64th.
//                  A radix select on every row, the first design, ran
//                  little faster than the 16 passes: its first digit's
//                  atomics collide in a few bins. Past that, the work per
//                  row that every warp repeats (barriers, reductions) set
//                  the pace, hence 8 warps a row and three rows an SM.
//                  Rows of fewer than ~2048 values pay that fixed work for
//                  little data and run slower than the 16 passes did
//                  (PERF.md, row 7).
//
// No fast-math: mid = 0.5f * (lo + hi) and every product must round as the
// plain version rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SHARED_DEFAULT = 48 * 1024;

int max_shared_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Opt a kernel in to `bytes` of dynamic shared memory where it needs more
// than a block gets by default.
template <typename K>
cudaError_t reserve_shared(K kernel, int bytes) {
  if (bytes > max_shared_optin()) return cudaErrorInvalidValue;
  if (bytes <= SHARED_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ------------------------------------------------------------ scale_add

constexpr int SCALE_THREADS = 512;

__global__ void __launch_bounds__(SCALE_THREADS)
scale_add_kernel(const float4* __restrict__ x, float4* __restrict__ out, int n4, int tile4) {
  extern __shared__ float4 scratch[];
  for (long long base = (long long)blockIdx.x * tile4; base < n4;
       base += (long long)gridDim.x * tile4) {
    const int m = n4 - base < tile4 ? (int)(n4 - base) : tile4;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float4 v = x[base + i];
      scratch[i] = make_float4(v.x * 2.f, v.y * 2.f, v.z * 2.f, v.w * 2.f);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float4 s = scratch[i];
      out[base + i] = make_float4(s.x + 1.f, s.y + 1.f, s.z + 1.f, s.w + 1.f);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ rowmax_mul

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int ROW_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
rowmax_mul_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int cols) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const T* xr = x + (size_t)row * cols;
  T* orow = out + (size_t)row * cols;
  float m = -INFINITY;
  for (int c = lane; c < cols; c += 32) m = nan_max(m, widen(xr[c]));
  for (int d = 16; d > 0; d >>= 1) m = nan_max(m, __shfl_xor_sync(FULL, m, d));
  for (int c = lane; c < cols; c += 32) orow[c] = narrow<T>(widen(xr[c]) * m);
}

// ------------------------------------------------------------ carry_and

template <typename C>
__global__ void carry_and_kernel(const float* __restrict__ x, const int* __restrict__ n,
                                 float* __restrict__ out, int rows, int cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  const int steps = min(*n, rows);
  C c = static_cast<C>(x[j] > 0.f);
  for (int i = 0; i < steps; ++i) {
    const bool m = x[(size_t)i * cols + j] > 0.5f;
    c = static_cast<C>(c & static_cast<C>(m));
  }
  out[j] = c ? 1.f : 0.f;
}

// ------------------------------------------------------------ bitcast_first

__global__ void bitcast_first_kernel(const float* __restrict__ x, int* __restrict__ out,
                                     int cols, int rank) {
  __shared__ int vec[1];
  int bits;
  if (rank == 0) {
    bits = __float_as_int(x[0]);
  } else {  // rank is uniform over the block
    if (threadIdx.x == 0) vec[0] = __float_as_int(x[0]);
    __syncthreads();
    bits = vec[0];
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < cols) out[j] = bits;
}

// ------------------------------------------------------------ bisect_mask

constexpr int BISECT_THREADS = 256;
constexpr int BISECT_WARPS = BISECT_THREADS / 32;
constexpr int BISECT_STEPS = 16;
constexpr int BISECT_K = 64;
constexpr float BISECT_HI = 1e6f;
// the key's digits, high to low
constexpr int BISECT_DIGIT1 = 11;
constexpr int BISECT_DIGIT2 = 11;
constexpr int BISECT_DIGIT3 = 10;
constexpr int BINS1 = 1 << BISECT_DIGIT1;
constexpr int BINS2 = 1 << BISECT_DIGIT2;
constexpr int BINS3 = 1 << BISECT_DIGIT3;
// float4s of the row that each thread keeps in registers (8192 values in all)
constexpr int BISECT_HELD = 8;
constexpr int BISECT_HELD_SLOTS = BISECT_HELD * BISECT_THREADS;
static_assert(BISECT_HELD == 8, "a thread holds the eight float4s that hold() rotates");
// lane minima of each warp that the bound counts: 8 warps x 8 = 64 values
constexpr int BISECT_LANES = BISECT_K / BISECT_WARPS;
// the most values under the bound that the rank select takes, one a thread
constexpr int BISECT_CANDIDATES = 256;
// one histogram (each digit's in turn) and the candidates, after the row's
// stages: 9 KB, so that three blocks of two 8192-wide stages fit an SM
constexpr int BISECT_SCRATCH = 4 * (BINS1 + BISECT_CANDIDATES);
static_assert(BISECT_DIGIT1 + BISECT_DIGIT2 + BISECT_DIGIT3 == 32 && BINS1 >= BINS2 && BINS1 >= BINS3,
              "the digits cover the key, and the histogram holds each");
static_assert(BISECT_LANES * BISECT_WARPS == BISECT_K && BISECT_CANDIDATES <= BISECT_THREADS,
              "the bound counts 64 lanes; a candidate a thread");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// A one-arrival mbarrier in shared memory, and the bulk copy (TMA) that
// completes on it: one thread asks for `bytes` (16-byte aligned, a multiple
// of 16) and the copy engine moves them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}
__device__ __forceinline__ bool bar_done(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned spin = 0; !bar_done(bar, parity); ++spin)
    if (spin == (1u << 26)) __trap();  // a copy that never lands fails the launch rather than hang
}

// The float's bits made an unsigned key in the floats' order (-0.0 just
// below +0.0; a NaN's key is never asked for), and back.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k ^ 0x80000000u : ~k);
}

// The row's 4-byte offset within 16 bytes: value c of the row sits at
// st[pad + c] of its stage, so that the 16-byte copies land aligned.
__device__ __forceinline__ int row_pad(const float* dr) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(dr) >> 2) & 3);
}

// Start the copy of the first n_s values of row dr into st[pad + c]: the
// 16-byte aligned body by one bulk copy completing on bar (thread 0, after
// a proxy fence: the stage's last reads went through the generic proxy), a
// head and a tail of up to 3 values by 4-byte cp.async. The slots before
// and after them, up to the float4 that holds the last, take NaN, which
// every sweep skips.
__device__ __forceinline__ void load_row(float* st, const float* dr, int n_s, uint64_t* bar) {
  const int t = threadIdx.x, pad = row_pad(dr);
  const int head = min((4 - pad) & 3, n_s);
  const int body = (n_s - head) >> 2;
  const int tail0 = head + 4 * body;
  if (t == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(st + pad + head, dr + head, 16u * body, bar);
  } else if (t <= head) {
    cp_async4(st + pad + t - 1, dr + t - 1);
  } else if (t >= 4 && t < 4 + n_s - tail0) {
    cp_async4(st + pad + tail0 + t - 4, dr + tail0 + t - 4);
  } else if (t >= 8 && t < 8 + pad) {
    st[t - 8] = NAN;
  } else if (t >= 12 && t < 12 + ((4 - pad - n_s) & 3)) {
    st[pad + n_s + t - 12] = NAN;
  }
}

// A quarter warp's eight lanes, each reading four neighbouring float4s of
// shared memory in this order, hit eight distinct 16-byte bank groups: lane
// pair p reads its j-th float4 at offset (j + p) & 3.
__device__ __forceinline__ int rot4() { return (threadIdx.x >> 1) & 3; }

// Four words read in rot4() order back in place: w_j belongs at word
// (rot + j) & 3.
__device__ __forceinline__ uint4 unrotate(unsigned w0, unsigned w1, unsigned w2, unsigned w3, int rot) {
  if (rot & 1) {
    const unsigned u = w3;
    w3 = w2;
    w2 = w1;
    w1 = w0;
    w0 = u;
  }
  if (rot & 2) {
    unsigned u = w0;
    w0 = w2;
    w2 = u;
    u = w1;
    w1 = w3;
    w3 = u;
  }
  return make_uint4(w0, w1, w2, w3);
}

// The float4s that thread t keeps in registers for the whole row: slots 8t
// .. 8t + 7 of the stage (128 bytes), v[j] = slot 8t + ((j + lane) & 7), so
// that a quarter warp reads eight distinct 16-byte bank groups; NaN past
// the n4 slots of the row.
__device__ __forceinline__ void hold(const float* st, int n4, float4 (&v)[BISECT_HELD]) {
  const float4* s4 = reinterpret_cast<const float4*>(st);
  const int rot = threadIdx.x & 7, first = BISECT_HELD * threadIdx.x;
  if (first + BISECT_HELD <= n4) {
#pragma unroll
    for (int j = 0; j < BISECT_HELD; ++j) v[j] = s4[first + ((j + rot) & 7)];
  } else {
#pragma unroll
    for (int j = 0; j < BISECT_HELD; ++j) {
      const int i = first + ((j + rot) & 7);
      v[j] = i < n4 ? s4[i] : make_float4(NAN, NAN, NAN, NAN);
    }
  }
}

// The 16 steps from v64: count(d <= mid) < 64 is v64 > mid. Returns hi,
// which never falls as v64 rises.
__device__ __forceinline__ float replay(float v64) {
  float lo = 0.f, hi = BISECT_HI;
#pragma unroll
  for (int s = 0; s < BISECT_STEPS; ++s) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (v64 > mid) lo = mid;
    else hi = mid;
  }
  return hi;
}

// f(value) for every value of the row: the held float4s, then the stage's
// slots past BISECT_HELD_SLOTS (slot i by thread (i - BISECT_HELD_SLOTS) mod
// BISECT_THREADS), then values n_s .. cols - 1, read through L2. NaN
// padding included. The trip counts are the same across a warp (a lane past
// the end sees NaN), so f may vote.
template <typename F>
__device__ __forceinline__ void each_value(const float4 (&v)[BISECT_HELD], const float* st, int n4,
                                           const float* dr, int n_s, int cols, F f) {
#pragma unroll
  for (int j = 0; j < BISECT_HELD; ++j) {
    f(v[j].x);
    f(v[j].y);
    f(v[j].z);
    f(v[j].w);
  }
  const float4* s4 = reinterpret_cast<const float4*>(st);
  const int lane = threadIdx.x & 31;
  for (int i0 = BISECT_HELD_SLOTS + threadIdx.x - lane; i0 < n4; i0 += BISECT_THREADS) {
    const float4 x = i0 + lane < n4 ? s4[i0 + lane] : make_float4(NAN, NAN, NAN, NAN);
    f(x.x);
    f(x.y);
    f(x.z);
    f(x.w);
  }
  for (int c0 = n_s + threadIdx.x - lane; c0 < cols; c0 += BISECT_THREADS)
    f(c0 + lane < cols ? __ldg(dr + c0 + lane) : NAN);
}

// The bin of hist[NB] that holds the k-th (from 1) counted key, by a block
// scan: sel = {bin, k less the keys of the bins below it}. Ends on a
// barrier.
template <int NB>
__device__ __forceinline__ void find_bin(const int* hist, int k, int* wsum, int* sel) {
  constexpr int PER = NB / BISECT_THREADS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = hist[t * PER + j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = incl - sum;
#pragma unroll
  for (int w = 0; w < BISECT_WARPS; ++w) before += w < warp ? wsum[w] : 0;
  if (before < k && k <= before + sum) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (before < k && k <= before + c[j]) {
        sel[0] = t * PER + j;
        sel[1] = k - before;
      }
      before += c[j];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned mask4(float hi, float4 v) {
  return static_cast<unsigned>(hi >= v.x) | static_cast<unsigned>(hi >= v.y) << 8 |
         static_cast<unsigned>(hi >= v.z) << 16 | static_cast<unsigned>(hi >= v.w) << 24;
}

// orow[c] = hi >= value c from the held float4s, when they are the whole
// row and (orow - pad) is 16-byte aligned: thread t's 32 columns from
// 32t - pad, two 16-byte streaming stores where all lie in the row, byte
// by byte at its two ends.
__device__ __forceinline__ void write_mask_held(const float4 (&v)[BISECT_HELD], int pad, int cols,
                                                uint8_t* orow, float hi) {
  unsigned w[BISECT_HELD];  // w[j] belongs at word (j + rot) & 7: turned back in three steps
#pragma unroll
  for (int j = 0; j < BISECT_HELD; ++j) w[j] = mask4(hi, v[j]);
  const int rot = threadIdx.x & 7;
#pragma unroll
  for (int step = 1; step < BISECT_HELD; step <<= 1) {
    if (rot & step) {
      unsigned u[BISECT_HELD];
#pragma unroll
      for (int j = 0; j < BISECT_HELD; ++j) u[(j + step) & 7] = w[j];
#pragma unroll
      for (int j = 0; j < BISECT_HELD; ++j) w[j] = u[j];
    }
  }
  const int c0 = 32 * static_cast<int>(threadIdx.x) - pad;
  if (c0 >= 0 && c0 + 32 <= cols) {
    __stcs(reinterpret_cast<uint4*>(orow + c0), make_uint4(w[0], w[1], w[2], w[3]));
    __stcs(reinterpret_cast<uint4*>(orow + c0 + 16), make_uint4(w[4], w[5], w[6], w[7]));
  } else if (c0 + 32 > 0 && c0 < cols) {
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (c0 + b >= 0 && c0 + b < cols) orow[c0 + b] = (w[b >> 2] >> (8 * (b & 3))) & 1u;
  }
}

// orow[c] = hi >= value c from the stage (and L2 past n_s), for any row: 16
// bytes a thread by streaming stores from the first 16-byte aligned byte,
// a scalar head and tail around them.
__device__ __forceinline__ void write_mask(const float* st, int pad, const float* dr, int n_s, int cols,
                                           uint8_t* orow, float hi) {
  const int t = threadIdx.x;
  auto at = [&](int c) { return c < n_s ? st[pad + c] : __ldg(dr + c); };
  const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(orow) & 15)) & 15), cols);
  const int chunks = (cols - head) >> 4;
  const int tail0 = head + 16 * chunks;
  if (t < head) orow[t] = hi >= at(t);
  else if (t >= 16 && t < 16 + cols - tail0) orow[tail0 + t - 16] = hi >= at(tail0 + t - 16);
  const bool vec = ((head + pad) & 3) == 0;
  const int rot = rot4();
  for (int q = t; q < chunks; q += BISECT_THREADS) {
    const int c0 = head + 16 * q;
    uint4 w;
    if (vec && c0 + 16 <= n_s) {
      const float4* p = reinterpret_cast<const float4*>(st + pad + c0);
      w = unrotate(mask4(hi, p[rot]), mask4(hi, p[(rot + 1) & 3]), mask4(hi, p[(rot + 2) & 3]),
                   mask4(hi, p[(rot + 3) & 3]), rot);
    } else {
      w = make_uint4(mask4(hi, make_float4(at(c0), at(c0 + 1), at(c0 + 2), at(c0 + 3))),
                     mask4(hi, make_float4(at(c0 + 4), at(c0 + 5), at(c0 + 6), at(c0 + 7))),
                     mask4(hi, make_float4(at(c0 + 8), at(c0 + 9), at(c0 + 10), at(c0 + 11))),
                     mask4(hi, make_float4(at(c0 + 12), at(c0 + 13), at(c0 + 14), at(c0 + 15))));
    }
    __stcs(reinterpret_cast<uint4*>(orow + c0), w);
  }
}

// Persistent blocks over the rows. Shared memory: `stages` stages of
// stage_floats floats (the row's first n_s values), then BISECT_SCRATCH.
__global__ void __launch_bounds__(BISECT_THREADS, 3)
bisect_mask_kernel(const float* __restrict__ d, uint8_t* __restrict__ out, int rows, int cols, int n_s,
                   int stage_floats, int stages) {
  extern __shared__ float4 bisect_smem[];
  __shared__ int wsum[BISECT_WARPS];
  __shared__ unsigned wbound[BISECT_WARPS];
  __shared__ int wlanes[BISECT_WARPS];
  __shared__ int sel[2];
  __shared__ unsigned hi_bits;
  __shared__ __align__(8) uint64_t landed[2];  // a stage's copy has landed
  float* const base = reinterpret_cast<float*>(bisect_smem);
  int* const hist = reinterpret_cast<int*>(base + stages * stage_floats);
  unsigned* const cand = reinterpret_cast<unsigned*>(hist + BINS1);
  const int t = threadIdx.x;
  if (t == 0) {
    bar_init(&landed[0]);
    bar_init(&landed[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int r = blockIdx.x;
  if (stages == 2) load_row(base, d + (size_t)r * cols, n_s, &landed[0]);
  cp_async_commit();
  for (int i = 0; r < rows; ++i, r += gridDim.x) {
    const float* dr = d + (size_t)r * cols;
    const int s = stages == 2 ? i & 1 : 0;
    float* const st = base + s * stage_floats;
    if (stages == 2) {  // the next row into the other stage, freed by the last row's final barrier
      const int rn = r + gridDim.x;
      if (rn < rows) load_row(base + (s ^ 1) * stage_floats, d + (size_t)rn * cols, n_s, &landed[s ^ 1]);
      cp_async_commit();
      cp_async_wait<1>();
      bar_wait(&landed[s], (i >> 1) & 1);
    } else {
      load_row(st, dr, n_s, &landed[0]);
      cp_async_commit();
      cp_async_wait<0>();
      bar_wait(&landed[0], i & 1);
    }
    if (t == 0) hi_bits = 0u;
    if (t < BISECT_WARPS) wlanes[t] = 0;
    __syncthreads();
    const int pad = row_pad(dr);
    const int n4 = (pad + n_s + 3) >> 2;
    float4 v[BISECT_HELD];
    hold(st, n4, v);

    // the bound: each lane's least value (NaN skipped) and, of the 8th
    // least of those in each warp, the least that 64 lanes' minima are at
    // or under (the largest always is: 8 lanes of each warp). So at least
    // 64 values lie at or under the bound. (+inf when a warp has fewer than
    // 8 lanes with values: then every value that is not NaN is taken.)
    // Reductions over the warps run across the lanes.
    const int lane = t & 31, warp = t >> 5;
    float m = INFINITY;
    each_value(v, st, n4, dr, n_s, cols, [&](float x) { m = fminf(m, x); });
    const unsigned own_min = order_key(m);
    unsigned mk = own_min;
#pragma unroll
    for (int j = 1; j < BISECT_LANES; ++j) {  // take the warp's least out, 7 times
      const unsigned least = __reduce_min_sync(FULL, mk);
      if (lane == __ffs(__ballot_sync(FULL, mk == least)) - 1) mk = 0xffffffffu;
    }
    mk = __reduce_min_sync(FULL, mk);
    if (lane == 0) wbound[warp] = mk;
    __syncthreads();
    const unsigned wb = lane < BISECT_WARPS ? wbound[lane] : 0xffffffffu;
    int lanes = 0;  // lane w: this warp's lanes at or under warp w's bound
#pragma unroll
    for (int w = 0; w < BISECT_WARPS; ++w) {
      const int c = __popc(__ballot_sync(FULL, own_min <= __shfl_sync(FULL, wb, w)));
      lanes = lane == w ? c : lanes;
    }
    if (lane < BISECT_WARPS) atomicAdd(&wlanes[lane], lanes);
    __syncthreads();
    const float bound = key_value(
        __reduce_min_sync(FULL, lane < BISECT_WARPS && wlanes[lane] >= BISECT_K ? wb : 0xffffffffu));
    // the values at or under it, as keys, at offsets from a block scan of
    // each thread's count (no atomics); keys of 0xffffffff pad them to
    // whole uint4s
    int mine = 0;
    each_value(v, st, n4, dr, n_s, cols, [&](float x) { mine += x <= bound; });
    int at = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, at, o);
      if (lane >= o) at += u;
    }
    if (lane == 31) wsum[warp] = at;
    __syncthreads();
    const int wn = lane < BISECT_WARPS ? wsum[lane] : 0;
    int wat = wn;  // the warps' counts, scanned across the lanes
#pragma unroll
    for (int o = 1; o < BISECT_WARPS; o <<= 1) {
      const int u = __shfl_up_sync(FULL, wat, o);
      if (lane >= o) wat += u;
    }
    const int n = __shfl_sync(FULL, wat, BISECT_WARPS - 1);
    at += __shfl_sync(FULL, wat - wn, warp) - mine;
    if (n <= BISECT_CANDIDATES) {
      each_value(v, st, n4, dr, n_s, cols, [&](float x) {
        if (x <= bound) cand[at++] = order_key(x);
      });
      if (t < ((4 - n) & 3)) cand[n + t] = 0xffffffffu;
    }
    __syncthreads();
    float hi = BISECT_HI;  // v64 = +inf when fewer than 64 values are not NaN
    if (n <= BISECT_CANDIDATES) {
      if (n >= BISECT_K) {
        // rank select: v64 is the largest key with fewer than 64 keys
        // under it, so hi is the largest of those keys' replays. Each key
        // takes P = 256 / n (to a power of 2, at most 32) neighbouring
        // threads, each counting over every P-th uint4.
        const int P = min(32, BISECT_THREADS >> (32 - __clz(n - 1)));
        const int own = t / P, part = t % P, groups = (n + 3) >> 2;
        const uint4* cand4 = reinterpret_cast<const uint4*>(cand);
        const unsigned c = own < n ? cand[own] : 0u;
        int less = 0;
#pragma unroll 4
        for (int j = own < n ? part : groups; j < groups; j += P) {
          const uint4 q = cand4[j];
          less += (q.x < c) + (q.y < c) + (q.z < c) + (q.w < c);
        }
        for (int o = 1; o < P; o <<= 1) less += __shfl_xor_sync(FULL, less, o);
        const bool below = own < n && less < BISECT_K;
        // hi > 0: its bits order as its values
        const unsigned best = __reduce_max_sync(FULL, below ? __float_as_uint(replay(key_value(c))) : 0u);
        if (lane == 0) atomicMax(&hi_bits, best);
        __syncthreads();
        hi = __uint_as_float(hi_bits);
      }
    } else {  // too many at the bound (ties, a narrow band): a radix select over the row
      auto clear = [&](int bins) {
        for (int b = t; b < bins; b += BISECT_THREADS) hist[b] = 0;
        __syncthreads();
      };
      clear(BINS1);
      each_value(v, st, n4, dr, n_s, cols, [&](float x) {
        if (x == x) atomicAdd(&hist[order_key(x) >> (32 - BISECT_DIGIT1)], 1);
      });
      __syncthreads();
      find_bin<BINS1>(hist, BISECT_K, wsum, sel);
      const unsigned p1 = sel[0];
      int k = sel[1];
      clear(BINS2);
      each_value(v, st, n4, dr, n_s, cols, [&](float x) {
        const unsigned u = order_key(x);
        if (x == x && (u >> (32 - BISECT_DIGIT1)) == p1) atomicAdd(&hist[(u >> BISECT_DIGIT3) & (BINS2 - 1)], 1);
      });
      __syncthreads();
      find_bin<BINS2>(hist, k, wsum, sel);
      const unsigned p2 = (p1 << BISECT_DIGIT2) | sel[0];
      k = sel[1];
      clear(BINS3);
      each_value(v, st, n4, dr, n_s, cols, [&](float x) {
        const unsigned u = order_key(x);
        if (x == x && (u >> BISECT_DIGIT3) == p2) atomicAdd(&hist[u & (BINS3 - 1)], 1);
      });
      __syncthreads();
      find_bin<BINS3>(hist, k, wsum, sel);
      hi = replay(key_value((p2 << BISECT_DIGIT3) | sel[0]));
    }

    uint8_t* const orow = out + (size_t)r * cols;
    if (n4 <= BISECT_HELD_SLOTS && n_s == cols && ((reinterpret_cast<uintptr_t>(orow) - pad) & 15) == 0)
      write_mask_held(v, pad, cols, orow, hi);
    else
      write_mask(st, pad, dr, n_s, cols, orow, hi);
    __syncthreads();  // the stage and the histograms are taken again
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// What bisect_mask's launcher asks the runtime once per device: the room
// for a row's stages beside the scratch, the SMs, and the resident blocks
// for the last shared-memory size launched.
struct BisectDevice {
  int room, sms, bytes, resident;
};
constexpr int BISECT_MAX_DEVICES = 64;
BisectDevice bisect_devices[BISECT_MAX_DEVICES];
std::mutex bisect_mutex;

}  // namespace

// x, out: n float32 (n a multiple of 4, 16-byte aligned). shared_bytes: the
// tile of each block, a multiple of 16.
extern "C" int scale_add(const void* x, void* out, int n, int shared_bytes, void* stream) {
  if (n <= 0) return 0;
  if (n % 4 != 0 || shared_bytes < 16 || shared_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = reserve_shared(scale_add_kernel, shared_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n4 = n / 4, tile4 = shared_bytes / 16;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scale_add_kernel, SCALE_THREADS,
                                                shared_bytes);
  const int tiles = (n4 + tile4 - 1) / tile4;
  const int resident = sm_count() * (per_sm > 0 ? per_sm : 1);
  scale_add_kernel<<<tiles < resident ? tiles : resident, SCALE_THREADS, shared_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n4, tile4);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. x, out: [rows, cols].
extern "C" int rowmax_mul(int dtype, const void* x, void* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int grid = (rows + ROW_WARPS - 1) / ROW_WARPS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rowmax_mul_kernel<float><<<grid, ROW_WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, cols);
  } else if (dtype == 1) {
    rowmax_mul_kernel<__nv_bfloat16><<<grid, ROW_WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), rows, cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: [rows, cols] float32; n: one int32 on the device; out: [cols] float32.
// as_bool: 0 carries an int, 1 a bool.
extern "C" int carry_and(int as_bool, const void* x, const void* n, void* out, int rows, int cols,
                         void* stream) {
  if (cols <= 0) return 0;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 128, grid = (cols + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ni = static_cast<const int*>(n);
  float* o = static_cast<float*>(out);
  if (as_bool) carry_and_kernel<bool><<<grid, threads, 0, s>>>(xf, ni, o, rows, cols);
  else carry_and_kernel<int><<<grid, threads, 0, s>>>(xf, ni, o, rows, cols);
  return (int)cudaGetLastError();
}

// x: at least one float32; out: [cols] int32. rank: 0 or 1.
extern "C" int bitcast_first(int rank, const void* x, void* out, int cols, void* stream) {
  if (cols <= 0) return 0;
  if (rank != 0 && rank != 1) return (int)cudaErrorInvalidValue;
  const int threads = 128, grid = (cols + threads - 1) / threads;
  bitcast_first_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(out), cols, rank);
  return (int)cudaGetLastError();
}

// d: [rows, cols] float32; out: [rows, cols] bool (one byte each). Any
// 4-byte aligned d and out. Two stages of a row when they fit in a block's
// shared memory beside the scratch, else one; a row past one stage's room
// keeps its first values there and reads the rest through L2.
extern "C" int bisect_mask(const void* d, void* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= BISECT_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(bisect_mutex);
  BisectDevice& g = bisect_devices[dev];
  if (g.sms == 0) {  // the kernel may take all the dynamic shared memory a block can have
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, bisect_mask_kernel);
    if (err != cudaSuccess) return (int)err;
    const int dynamic = max_shared_optin() - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(bisect_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (err != cudaSuccess) return (int)err;
    g.room = dynamic - BISECT_SCRATCH;
    g.sms = sm_count();
  }
  const int slots = (cols + 6) & ~3;  // up to 3 slots of padding, whole float4s
  int stages = 2, stage_floats = slots, n_s = cols;
  if (8 * slots > g.room) {
    stages = 1;
    if (4 * slots > g.room) {
      stage_floats = (g.room / 4) & ~3;
      n_s = stage_floats - 3;
    }
  }
  const int bytes = 4 * stages * stage_floats + BISECT_SCRATCH;
  if (bytes != g.bytes) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bisect_mask_kernel, BISECT_THREADS, bytes);
    if (err != cudaSuccess) return (int)err;
    g.resident = g.sms * (per_sm > 0 ? per_sm : 1);
    g.bytes = bytes;
  }
  bisect_mask_kernel<<<rows < g.resident ? rows : g.resident, BISECT_THREADS, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<uint8_t*>(out), rows, cols, n_s, stage_floats, stages);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
