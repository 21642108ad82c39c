// Exact 64-nearest-neighbour selection for padded structures (sm_90a).
//
// Replaces pesto_tpu/ops/knn_pallas.py:knn_candidates (line 177; its body
// _kernel at line 74) and knn_select (line 256). The TPU kernel proposes a
// candidate superset (Morton band, 16-step bisection, compaction into 384
// slots) and falls back to the exact XLA path on overflow. This kernel owes
// only the output contract of that exact path (pesto_tpu/topology.py
// _knn_core): per row, the lexicographic (value, id) top-64 of the masked
// Gram-form squared distances, the ok mask (value < 5e9), and, where the
// caller asks for it, per structure Dmax^2 = max Dsq over valid pairs. It
// is exact by construction: no candidate budget can fail, and n <= k needs
// no special case.
//
// Bound on the H100: the arithmetic of the pairs evaluated (a 3-term dot
// product and the Gram combination, ~8 fp32 operations each); the bytes are
// tiny (16 B per atom in, 320 B per row out). A [NA, NA] matrix is never
// formed. A row needs only the atoms near it, so the design evaluates few
// pairs and spends no serial work per candidate:
//
//  1. morton_box_kernel, morton_keys_kernel: per structure, the 30-bit
//     Morton code of each valid atom over the structure's bounding box (10
//     bits per axis, in float64, as pesto_tpu/spatial.py morton_order);
//     sink and padding get 2^30. The caller sorts the keys (torch.sort,
//     stable).
//  2. gather_boxes_kernel: the atoms in that order as float4 with their
//     original ids, and an axis-aligned box (and the largest w) for every
//     tile of 32 sorted atoms and every group of 32 tiles.
//  3. knn_scan_kernel: one warp takes one sorted row (measured faster than
//     two or four rows per warp). It first takes the 7 tiles around its
//     own (the window): a bisection over the value bits of those 224
//     candidates, held in registers, gives the row a tau at or just above
//     the window's 64th, which bounds the row's true 64th from above. Then
//     it takes the other groups and tiles, and skips a box when its least
//     squared distance to the row's atom, rounded down, exceeds the row's
//     tau as it then is plus the Gram form's rounding margin. In a tile it
//     keeps, each lane computes one column; the columns whose (value, id) key is at most the
//     row's tau append to the row's buffer in shared memory at a slot from
//     one ballot and a popcount. A buffer past 96 of its 128
//     slots is cut by the same bisection to the keys under its 64th's bound
//     (or, if ties leave no room, to its exact top 64), which tightens tau;
//     a cut keeps every key that can still be in the top 64, so no budget
//     can fail. At the end a warp-wide bitonic sort of 64-bit keys (value
//     bits << 32 | original id; values are >= 0, so the bits order like the
//     floats) gives the top 64, written at the original row.
//  4. knn_dmax_kernel (only when Dmax is asked for): a dense max over all
//     valid pairs of the same values.
//
// Every value is the float4 Gram expression of gram() below, on the same
// float4 atoms, so the values and the selected ids are those of the
// one-warp-per-row kernel this replaces, bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int K = 64;
constexpr int TILE = 32;           // sorted atoms per tile (one per lane)
constexpr int GROUP = 32 * TILE;   // sorted atoms per group of 32 tiles
constexpr int WARPS = 4;           // warps per scan block
constexpr int SLOTS = 128;         // candidate buffer per row
constexpr int WINDOW = 3;          // window: the row's tile and WINDOW tiles each side
constexpr unsigned FULL = 0xffffffffu;
constexpr float PUSH = 4e9f;
constexpr float BIGHALF = 5e9f;
// The Gram form rounds by at most ~9 * 2^-24 * (w_i + w_j); the prune test
// adds MARGIN_REL * (w_rows + w_tile) + MARGIN_ABS to tau, rounded up.
constexpr float MARGIN_REL = 2e-6f;
constexpr float MARGIN_ABS = 1e-6f;
constexpr u64 NONE = ~0ull;
constexpr int INVALID_KEY = 1 << 30;

__device__ __forceinline__ float gram(float4 xi, float4 xj) {
  const float dot = xi.x * xj.x + xi.y * xj.y + xi.z * xj.z;
  return fmaxf(xi.w + xj.w - 2.f * dot, 0.f);
}

// The masked value of column j (original id) for row i: self and
// near-duplicates pushed by 4e9.
__device__ __forceinline__ float value(float4 xi, int i, float4 xj, int j) {
  const float dsq = gram(xi, xj);
  return (j == i || dsq < 1e-4f) ? dsq + PUSH : dsq;
}

__device__ __forceinline__ u64 make_key(float v, int id) {
  return ((u64)__float_as_uint(v) << 32) | (unsigned)id;
}

__device__ __forceinline__ unsigned spread10(unsigned v) {
  v = (v | (v << 16)) & 0xff0000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ unsigned quant10(float x, double lo, double span) {
  const double q = ((double)x - lo) / span * 1024.0;
  return (unsigned)min((unsigned long long)q, 1023ull);
}

constexpr int PREP = 1024;  // atoms per block of the Morton pass

// Min and max of x, y, z in v[0..5] and a count in v[6], over the block:
// the result in red[0] (PREP threads).
__device__ __forceinline__ void block_box(float (&v)[7], float (*red)[7]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) v[a] = fminf(v[a], __shfl_xor_sync(FULL, v[a], d));
#pragma unroll
    for (int a = 3; a < 6; ++a) v[a] = fmaxf(v[a], __shfl_xor_sync(FULL, v[a], d));
    v[6] += __shfl_xor_sync(FULL, v[6], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 7; ++a) red[warp][a] = v[a];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 7; ++a) v[a] = red[lane][a];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = fminf(v[a], __shfl_xor_sync(FULL, v[a], d));
#pragma unroll
      for (int a = 3; a < 6; ++a) v[a] = fmaxf(v[a], __shfl_xor_sync(FULL, v[a], d));
      v[6] += __shfl_xor_sync(FULL, v[6], d);
    }
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 7; ++a) red[0][a] = v[a];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void empty_box(float (&v)[7]) {
  v[0] = v[1] = v[2] = INFINITY;
  v[3] = v[4] = v[5] = -INFINITY;
  v[6] = 0.f;
}

// grid (ceil(NA / PREP), B), PREP threads: each block's box of its valid
// atoms into part [B, blocks, 8].
__global__ void __launch_bounds__(PREP)
morton_box_kernel(const float4* __restrict__ xc, int na, float* __restrict__ part) {
  __shared__ float red[32][7];
  const int i = blockIdx.x * PREP + threadIdx.x;
  float v[7];
  empty_box(v);
  if (i < na) {
    const float4 p = xc[(size_t)blockIdx.y * na + i];
    if (p.w >= 0.f) {
      v[0] = v[3] = p.x;
      v[1] = v[4] = p.y;
      v[2] = v[5] = p.z;
      v[6] = 1.f;
    }
  }
  block_box(v, red);
  if (threadIdx.x < 7) part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8 + threadIdx.x] = red[0][threadIdx.x];
}

// grid (ceil(NA / PREP), B), PREP threads: the structure's box from the
// partial boxes, then the keys [B, NA] int32 of the block's atoms; block 0
// writes nvalid [B].
__global__ void __launch_bounds__(PREP)
morton_keys_kernel(const float4* __restrict__ xc, int na, const float* __restrict__ part,
                   int* __restrict__ keys, int* __restrict__ nvalid) {
  __shared__ float red[32][7];
  float v[7];
  empty_box(v);
  for (int j = threadIdx.x; j < gridDim.x; j += PREP) {
    const float* q = part + ((size_t)blockIdx.y * gridDim.x + j) * 8;
    v[0] = fminf(v[0], q[0]); v[1] = fminf(v[1], q[1]); v[2] = fminf(v[2], q[2]);
    v[3] = fmaxf(v[3], q[3]); v[4] = fmaxf(v[4], q[4]); v[5] = fmaxf(v[5], q[5]);
    v[6] += q[6];
  }
  block_box(v, red);
  const double lo[3] = {red[0][0], red[0][1], red[0][2]};
  double span[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) span[a] = fmax((double)red[0][3 + a] - lo[a], 1e-9);
  if (blockIdx.x == 0 && threadIdx.x == 0) nvalid[blockIdx.y] = (int)red[0][6];
  const int i = blockIdx.x * PREP + threadIdx.x;
  if (i >= na) return;
  const float4 p = xc[(size_t)blockIdx.y * na + i];
  int key = INVALID_KEY;
  if (p.w >= 0.f)
    key = (int)(spread10(quant10(p.x, lo[0], span[0])) |
                (spread10(quant10(p.y, lo[1], span[1])) << 1) |
                (spread10(quant10(p.z, lo[2], span[2])) << 2));
  keys[(size_t)blockIdx.y * na + i] = key;
}

// Scratch layout, in float words, in this order: xs [B, NA] float4, tile
// boxes [B, ntiles, 2] float4, group boxes [B, ngroups, 2] float4, sid
// [B, NA] int32. A box is (min x, y, z, max w) then (max x, y, z, 0) over
// the valid atoms it holds. knn_scratch_floats gives the caller its size.
enum { XS, TBOX, GBOX, SID, END };

__host__ inline void scratch_layout(int batch, int na, size_t (&off)[END + 1]) {
  const size_t nt = (na + TILE - 1) / TILE, ng = (na + GROUP - 1) / GROUP;
  off[XS] = 0;
  off[TBOX] = off[XS] + 4 * (size_t)batch * na;
  off[GBOX] = off[TBOX] + 8 * (size_t)batch * nt;
  off[SID] = off[GBOX] + 8 * (size_t)batch * ng;
  off[END] = off[SID] + (size_t)batch * na;
}

struct Scratch {
  float4* xs;
  float4* tbox;
  float4* gbox;
  int* sid;
};

__host__ inline Scratch carve(void* base, int batch, int na) {
  size_t off[END + 1];
  scratch_layout(batch, na, off);
  float* const f = static_cast<float*>(base);
  return {reinterpret_cast<float4*>(f + off[XS]), reinterpret_cast<float4*>(f + off[TBOX]),
          reinterpret_cast<float4*>(f + off[GBOX]), reinterpret_cast<int*>(f + off[SID])};
}

__device__ __forceinline__ void warp_box(float4 p, bool valid, float4& lo, float4& hi) {
  lo = valid ? make_float4(p.x, p.y, p.z, p.w) : make_float4(INFINITY, INFINITY, INFINITY, -INFINITY);
  hi = valid ? make_float4(p.x, p.y, p.z, 0.f) : make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
  for (int d = 16; d > 0; d >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(FULL, lo.x, d));
    lo.y = fminf(lo.y, __shfl_xor_sync(FULL, lo.y, d));
    lo.z = fminf(lo.z, __shfl_xor_sync(FULL, lo.z, d));
    lo.w = fmaxf(lo.w, __shfl_xor_sync(FULL, lo.w, d));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(FULL, hi.x, d));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(FULL, hi.y, d));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(FULL, hi.z, d));
  }
}

// grid (ngroups, B), 1024 threads: one sorted atom per thread, one tile per
// warp, one group per block.
__global__ void __launch_bounds__(1024)
gather_boxes_kernel(const float4* __restrict__ xc, const int64_t* __restrict__ perm, int na,
                    Scratch s) {
  __shared__ float4 part[32][2];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pos = blockIdx.x * GROUP + threadIdx.x;
  const int nt = (na + TILE - 1) / TILE, ng = (na + GROUP - 1) / GROUP;
  float4 p = make_float4(0.f, 0.f, 0.f, -1.f);
  if (pos < na) {
    const int id = (int)perm[(size_t)b * na + pos];
    p = xc[(size_t)b * na + id];
    s.xs[(size_t)b * na + pos] = p;
    s.sid[(size_t)b * na + pos] = id;
  }
  float4 lo, hi;
  warp_box(p, pos < na && p.w >= 0.f, lo, hi);
  const int t = pos / TILE;
  if (lane == 0) {
    part[warp][0] = lo;
    part[warp][1] = hi;
    if (t < nt) {
      s.tbox[((size_t)b * nt + t) * 2] = lo;
      s.tbox[((size_t)b * nt + t) * 2 + 1] = hi;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float4 glo = part[lane][0], ghi = part[lane][1];
    for (int d = 16; d > 0; d >>= 1) {
      glo.x = fminf(glo.x, __shfl_xor_sync(FULL, glo.x, d));
      glo.y = fminf(glo.y, __shfl_xor_sync(FULL, glo.y, d));
      glo.z = fminf(glo.z, __shfl_xor_sync(FULL, glo.z, d));
      glo.w = fmaxf(glo.w, __shfl_xor_sync(FULL, glo.w, d));
      ghi.x = fmaxf(ghi.x, __shfl_xor_sync(FULL, ghi.x, d));
      ghi.y = fmaxf(ghi.y, __shfl_xor_sync(FULL, ghi.y, d));
      ghi.z = fmaxf(ghi.z, __shfl_xor_sync(FULL, ghi.z, d));
    }
    if (lane == 0 && blockIdx.x < ng) {
      s.gbox[((size_t)b * ng + blockIdx.x) * 2] = glo;
      s.gbox[((size_t)b * ng + blockIdx.x) * 2 + 1] = ghi;
    }
  }
}

// In-warp bitonic sort of NR * 32 keys, element e = r * 32 + lane.
template <int NR>
__device__ __forceinline__ void bitonic(u64 (&a)[NR], int lane) {
  static_assert(NR == 2 || NR == 4, "NR is 2 or 4");
  constexpr int LOG = NR == 2 ? 6 : 7;
#pragma unroll
  for (int lk = 1; lk <= LOG; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= 32) {
        const int rj = j >> 5;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if ((r & rj) == 0) {
            const bool up = ((r * 32 + lane) & k) == 0;
            const u64 x = a[r], y = a[r | rj];
            if ((x > y) == up) {
              a[r] = y;
              a[r | rj] = x;
            }
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const u64 y = __shfl_xor_sync(FULL, a[r], j);
          const bool keep_min = ((lane & j) == 0) == (((r * 32 + lane) & k) == 0);
          a[r] = keep_min ? (a[r] < y ? a[r] : y) : (a[r] < y ? y : a[r]);
        }
      }
    }
  }
}

template <int NR>
__device__ __forceinline__ u64 sort_keep(u64* buf, int cnt, int lane) {
  u64 a[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) a[r] = r * 32 + lane < cnt ? buf[r * 32 + lane] : NONE;
  bitonic<NR>(a, lane);
  __syncwarp();
  buf[lane] = a[0];
  buf[32 + lane] = a[1];
  __syncwarp();
  return __shfl_sync(FULL, a[1], 31);
}

// Sort the row's cnt <= SLOTS buffered keys and keep the first 64 at
// buf[0..63] (NONE past cnt); returns the 64th key, NONE when cnt < 64.
__device__ __noinline__ u64 select64(u64* buf, int cnt, int lane) {
  static_assert(SLOTS == 128, "select64 sorts 64 or 128 keys");
  __syncwarp();
  if (cnt <= 64) return sort_keep<2>(buf, cnt, lane);
  return sort_keep<4>(buf, cnt, lane);
}

// The least 16-bit prefix p of the keys' value bits (key >> 48) that at
// least 64 of the keys k[] (NONE for none) have at or under it, by a
// bisection over p; returns the largest key with prefix p. Every key up
// to it is kept, so it bounds the 64th key from above, within 2^-7 of its
// value. NQ keys per lane, at least 64 of them real.
template <int NQ>
__device__ __forceinline__ u64 prefix_bound(const u64 (&k)[NQ]) {
  // the bisection runs between the least and the largest real prefix
  unsigned plo = 0xffffu, phi = 0u;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const unsigned p = (unsigned)(k[q] >> 48);
    if (p != 0xffffu) {
      plo = min(plo, p);
      phi = max(phi, p);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    plo = min(plo, __shfl_xor_sync(FULL, plo, d));
    phi = max(phi, __shfl_xor_sync(FULL, phi, d));
  }
  while (plo < phi) {
    const unsigned mid = (plo + phi) >> 1;
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) cnt += __popc(__ballot_sync(FULL, (unsigned)(k[q] >> 48) <= mid));
    if (cnt >= K) phi = mid;
    else plo = mid + 1;
  }
  return ((u64)((plo << 16) | 0xffffu) << 32) | 0xffffffffu;
}

struct Cut {
  u64 tau;
  int cnt;
};

// A buffer past SLOTS - TILE keys is cut: to the keys at or under the
// prefix bound of its 64th (ties in the prefix stay), or, when those leave
// no room for a tile, to its exact top 64. Either way every key that can
// still be in the row's top 64 stays, and tau tightens.
__device__ __noinline__ Cut shrink(u64* buf, int cnt, u64 tau, int lane) {
  constexpr int NQ = SLOTS / 32;
  __syncwarp();
  u64 k[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) k[q] = q * 32 + lane < cnt ? buf[q * 32 + lane] : NONE;
  const u64 t = prefix_bound<NQ>(k);
  if (t < tau) tau = t;
  __syncwarp();
  int kept = 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const bool keep = k[q] <= tau;
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) buf[kept + __popc(m & ((1u << lane) - 1u))] = k[q];
    kept += __popc(m);
  }
  if (kept > SLOTS - TILE) {
    tau = select64(buf, kept, lane);
    kept = K;
  }
  return {tau, kept};
}

__device__ __forceinline__ float key_value(u64 key) {
  return key == NONE ? INFINITY : __uint_as_float((unsigned)(key >> 32));
}

// The warp's row: its sorted atom, original id, threshold, buffer fill,
// and the cuts of its buffer so far (tau changed since a test if they did).
struct Row {
  float4 x;
  int id;
  u64 tau;
  int cnt;
  int cuts;
};

// Whether the box (lo, hi) can hold a column that the row needs: the least
// squared distance from the row's atom to the box, rounded down, against
// the row's tau plus the rounding margin of the Gram form for their atoms,
// rounded up.
__device__ __forceinline__ bool box_near(const float4* box, const Row& R) {
  const float4 lo = box[0], hi = box[1], x = R.x;
  const float gx = fmaxf(fmaxf(__fsub_rd(lo.x, x.x), __fsub_rd(x.x, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rd(lo.y, x.y), __fsub_rd(x.y, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rd(lo.z, x.z), __fsub_rd(x.z, hi.z)), 0.f);
  const float dr = __fadd_rd(__fadd_rd(__fmul_rd(gx, gx), __fmul_rd(gy, gy)), __fmul_rd(gz, gz));
  const float margin = __fmaf_ru(MARGIN_REL, __fadd_ru(x.w, lo.w), MARGIN_ABS);
  return !(dr > __fadd_ru(key_value(R.tau), margin));
}

// Append the keys of the lanes that pass to the row's buffer (one ballot
// and a popcount give the slots), then cut the buffer if it is past
// SLOTS - TILE, so that the next tile always fits.
__device__ __forceinline__ void append(Row& R, u64* buf, u64 key, bool pass, int lane, int& fill) {
  const unsigned m = __ballot_sync(FULL, pass);
  if (pass) buf[R.cnt + __popc(m & ((1u << lane) - 1u))] = key;
  R.cnt += __popc(m);
  if (R.cnt <= SLOTS - TILE) return;
  fill = max(fill, R.cnt);
  const Cut c = shrink(buf, R.cnt, R.tau, lane);
  R.tau = c.tau;
  R.cnt = c.cnt;
  R.cuts += 1;
}

// One tile of 32 sorted columns against the warp's row.
__device__ __forceinline__ void scan_tile(Row& R, u64* buf, const float4* xs, const int* sid,
                                          int n, int tile, int lane, u64& pairs, int& fill) {
  const int c = tile * TILE + lane;
  const bool cv = c < n;
  const float4 xj = cv ? xs[c] : make_float4(0.f, 0.f, 0.f, -1.f);
  const int idj = cv ? sid[c] : 0;
  pairs += __popc(__ballot_sync(FULL, cv));
  const u64 key = make_key(value(R.x, R.id, xj, idj), idj);
  append(R, buf, key, cv && key <= R.tau, lane, fill);
}

constexpr int WTILES = 2 * WINDOW + 1;

// The window (tiles lo..hi-1): its keys stay in registers while
// prefix_bound gives the row a tau at or just above the window's 64th,
// which bounds the row's true 64th from above; with fewer than 64 valid
// atoms in the window tau stays NONE (no bound). The window's keys at or
// under tau then go to the buffer.
__device__ __forceinline__ void window_tau(Row& R, u64* buf, const float4* xs, const int* sid,
                                           int n, int lo, int hi, int lane, u64& pairs,
                                           int& fill) {
  u64 wk[WTILES];
  int total = 0;
#pragma unroll
  for (int w = 0; w < WTILES; ++w) {
    const int c = (lo + w) * TILE + lane;
    const bool ok = lo + w < hi && c < n;
    const float4 xj = ok ? xs[c] : make_float4(0.f, 0.f, 0.f, -1.f);
    const int idj = ok ? sid[c] : 0;
    wk[w] = ok ? make_key(value(R.x, R.id, xj, idj), idj) : NONE;
    total += __popc(__ballot_sync(FULL, ok));
  }
  pairs += total;
  if (total >= K) R.tau = prefix_bound<WTILES>(wk);
#pragma unroll
  for (int w = 0; w < WTILES; ++w)
    append(R, buf, wk[w], wk[w] <= R.tau && wk[w] != NONE, lane, fill);
}

// grid (ceil(NA / WARPS), B), WARPS * 32 threads: one sorted row per warp.
// stats (may be null): [0] pairs evaluated, [1] largest buffer fill,
// [2] rows whose buffer was cut, [3] cuts.
__global__ void __launch_bounds__(WARPS * 32)
knn_scan_kernel(Scratch s, const int* __restrict__ nvalid, int na, int* __restrict__ ids,
                uint8_t* __restrict__ ok, u64* __restrict__ stats) {
  __shared__ u64 buf_all[WARPS][SLOTS];
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= na) return;
  u64* buf = buf_all[warp];
  const int n = nvalid[b];
  const int ntiles = (na + TILE - 1) / TILE, ngroups = (na + GROUP - 1) / GROUP;
  const float4* xs = s.xs + (size_t)b * na;
  const int* sid = s.sid + (size_t)b * na;
  const float4* tbox = s.tbox + (size_t)b * ntiles * 2;
  const float4* gbox = s.gbox + (size_t)b * ngroups * 2;
  const int id = sid[p];
  int* out_ids = ids + ((size_t)b * na + id) * K;
  uint8_t* out_ok = ok + ((size_t)b * na + id) * K;
  if (p >= n) {  // the sink and padding sort last and have no neighbours
    out_ids[lane] = 0;
    out_ids[32 + lane] = 0;
    out_ok[lane] = 0;
    out_ok[32 + lane] = 0;
    return;
  }

  Row R{xs[p], id, NONE, 0, 0};
  u64 pairs = 0;
  int fill = 0;
  const int nt = (n + TILE - 1) / TILE, ng = (n + GROUP - 1) / GROUP;
  const int t = p / TILE;
  const int lo = max(0, min(t - WINDOW, nt - WTILES));
  const int hi = min(nt, lo + WTILES);
  window_tau(R, buf, xs, sid, n, lo, hi, lane, pairs, fill);
  // Groups, then their tiles, each box tested against the row's tau and,
  // if a cut has tightened tau since, again when its turn comes.
  const int rounds = (ng + 31) / 32, own = t / 32 / 32;
  for (int ri = 0; ri < rounds; ++ri) {
    const int g0 = (own + ri) % rounds * 32;  // the row's own round of groups first
    const int gl = g0 + lane;
    unsigned gm = __ballot_sync(FULL, gl < ng && box_near(gbox + 2 * gl, R));
    const int gcuts = R.cuts;
    while (gm) {
      const int g = g0 + __ffs(gm) - 1;
      gm &= gm - 1;
      if (R.cuts != gcuts && !box_near(gbox + 2 * g, R)) continue;
      const int tl = g * 32 + lane;
      unsigned tm =
          __ballot_sync(FULL, tl < nt && (tl < lo || tl >= hi) && box_near(tbox + 2 * tl, R));
      const int tcuts = R.cuts;
      while (tm) {
        const int tile = g * 32 + __ffs(tm) - 1;
        tm &= tm - 1;
        if (R.cuts == tcuts || box_near(tbox + 2 * tile, R))
          scan_tile(R, buf, xs, sid, n, tile, lane, pairs, fill);
      }
    }
  }

  fill = max(fill, R.cnt);
  select64(buf, R.cnt, lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u64 key = buf[h * 32 + lane];
    const bool good = key != NONE && key_value(key) < BIGHALF;
    out_ids[h * 32 + lane] = good ? (int)(unsigned)(key & 0xffffffffu) : 0;
    out_ok[h * 32 + lane] = good;
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, pairs);
    atomicMax(stats + 1, (u64)fill);
    atomicAdd(stats + 2, (u64)(R.cuts > 0));
    atomicAdd(stats + 3, (u64)R.cuts);
  }
}

constexpr int DM_THREADS = 256;
constexpr int DM_RROWS = 2;                      // rows per thread
constexpr int DM_ROWS = DM_THREADS * DM_RROWS;   // rows per block
constexpr int DM_COLS = 1024;                    // columns per block

// grid (ceil(NA / DM_ROWS), ceil(NA / DM_COLS), B): max Dsq over the valid
// pairs of a row block and a column block, atomicMax into dmax_bits[b]
// (Dsq >= 0, so the unsigned order of the bits is the float order).
__global__ void __launch_bounds__(DM_THREADS)
knn_dmax_kernel(const float4* __restrict__ xc, int na, unsigned int* __restrict__ dmax_bits) {
  __shared__ float4 cols[DM_COLS];
  const int b = blockIdx.z;
  const float4* xb = xc + (size_t)b * na;
  const int c0 = blockIdx.y * DM_COLS;
  const int nc = min(DM_COLS, na - c0);
  for (int c = threadIdx.x; c < nc; c += DM_THREADS) cols[c] = xb[c0 + c];
  __syncthreads();
  float4 xi[DM_RROWS];
  bool any = false;
#pragma unroll
  for (int q = 0; q < DM_RROWS; ++q) {
    const int row = blockIdx.x * DM_ROWS + q * DM_THREADS + threadIdx.x;
    xi[q] = row < na ? xb[row] : make_float4(0.f, 0.f, 0.f, -1.f);
    any |= xi[q].w >= 0.f;
  }
  float m = 0.f;
  if (any) {
    for (int c = 0; c < nc; ++c) {
      const float4 xj = cols[c];
      if (xj.w < 0.f) continue;
#pragma unroll
      for (int q = 0; q < DM_RROWS; ++q)
        if (xi[q].w >= 0.f) m = fmaxf(m, gram(xi[q], xj));
    }
  }
  for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
  if ((threadIdx.x & 31) == 0 && m > 0.f) atomicMax(dmax_bits + b, __float_as_uint(m));
}

int launch_top64(const void* xc, const void* perm, int batch, int na, void* scratch,
                 const void* nvalid, void* ids, void* ok, void* stats, void* stream) {
  if (batch <= 0 || na <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, batch, na);
  const int ngroups = (na + GROUP - 1) / GROUP;
  gather_boxes_kernel<<<dim3(ngroups, batch), 1024, 0, st>>>(
      static_cast<const float4*>(xc), static_cast<const int64_t*>(perm), na, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  knn_scan_kernel<<<dim3((na + WARPS - 1) / WARPS, batch), WARPS * 32, 0, st>>>(
      s, static_cast<const int*>(nvalid), na, static_cast<int*>(ids),
      static_cast<uint8_t*>(ok), static_cast<u64*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xc: [B, NA] float4 (x, y, z, w), centred, w = |x|^2 for a valid atom and
// -1 for the sink and padding. part: [B, ceil(NA / 1024), 8] float32
// scratch; keys: [B, NA] int32; nvalid: [B] int32.
extern "C" int knn_prep(const void* xc, int batch, int na, void* part, void* keys,
                        void* nvalid, void* stream) {
  if (batch <= 0 || na <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((na + PREP - 1) / PREP, batch);
  morton_box_kernel<<<grid, PREP, 0, st>>>(static_cast<const float4*>(xc), na,
                                           static_cast<float*>(part));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  morton_keys_kernel<<<grid, PREP, 0, st>>>(static_cast<const float4*>(xc), na,
                                            static_cast<const float*>(part),
                                            static_cast<int*>(keys), static_cast<int*>(nvalid));
  return static_cast<int>(cudaGetLastError());
}

// perm: [B, NA] int64, the stable sort of the keys; scratch:
// knn_scratch_floats(B, NA) float32 words; ids/ok: [B, NA, 64].
extern "C" int knn_top64(const void* xc, const void* perm, int batch, int na, void* scratch,
                         const void* nvalid, void* ids, void* ok, void* stream) {
  return launch_top64(xc, perm, batch, na, scratch, nvalid, ids, ok, nullptr, stream);
}

// The same, with stats: [4] uint64, zeroed by the caller.
extern "C" int knn_top64_stats(const void* xc, const void* perm, int batch, int na,
                               void* scratch, const void* nvalid, void* ids, void* ok,
                               void* stats, void* stream) {
  return launch_top64(xc, perm, batch, na, scratch, nvalid, ids, ok, stats, stream);
}

// float32 words of knn_top64's scratch.
extern "C" long long knn_scratch_floats(int batch, int na) {
  size_t off[END + 1];
  scratch_layout(batch, na, off);
  return (long long)off[END];
}

// dmax_bits: [B], zeroed by the caller.
extern "C" int knn_dmax(const void* xc, int batch, int na, void* dmax_bits, void* stream) {
  if (batch <= 0 || na <= 0) return 0;
  const dim3 grid((na + DM_ROWS - 1) / DM_ROWS, (na + DM_COLS - 1) / DM_COLS, batch);
  knn_dmax_kernel<<<grid, DM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(xc), na, static_cast<unsigned int*>(dmax_bits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
