// Fused edge attention of one geometric state-update layer (sm_90a).
//
// Replaces pesto_tpu/ops/geometric_pallas.py:fused_edge_attention (line 257;
// its body _kernel at line 125): everything of StateUpdate that follows the
// neighbour gather (pesto_tpu/models/pesto.py:202-337). Per edge (atom n,
// neighbour slot j, neighbour m = ids[n, j]):
//
//   E   = [q_m, |p_m|, <p_n, r_nj>, <p_m, r_nj>]                  (4S = 128)
//   h0  = elu(E K0e + d_nj K0[0] + ([q_n, |p_n|] K0[1:2S+1] + B0))  (128)
//   h1  = elu(h0 K1 + B1)          K1 block-diagonal 32|32|64      (128)
//   out = h1 K2 + B2               K2 block-diagonal 3|9|64        (76)
//
// then, per atom and head, the scalar softmax over the nn edges, the vector
// softmax over the 3*nn (edge, c-plane) logits jointly, and the value sums
//
//   Zq[h, s]    = sum_j Mq[h, j] V0[j, s]
//   Zp[x, h, s] = sum_j Mp1[h, j] r[j, x] V1[j, s]
//               + (sum_j Mp2[h, j]) p_n[x, s] + sum_j Mp3[h, j] p_m[x, s]
//
// Zq is [N, Nh*S]; Zp is [N, 3*Nh*S], x-major then head (the torch view).
// The kernel reads atom-major states qp [N, 4S] and neighbour ids [N, nn]
// and gathers the neighbour rows itself: the gathered [N, nn, 4S] tensor and
// every [N, nn, *] intermediate stay on chip.
//
// Bound on the H100: the three edge-MLP products, 2 * (128*128 + 2*32*32 +
// 64*64 + 32*3 + 32*9 + 64*64) = 54,016 FLOP per edge with the
// block-diagonal structure, 97% of the work. They run on the tensor cores
// (mma.sync), so the bound is the tensor-core rate: bf16 operands at 989
// TFLOP/s; fp32 as three TF32 products at 495 TFLOP/s (0.175 ms at N = 8192,
// nn = 64, against 0.432 ms for fp32 FMA on the CUDA cores). What holds the
// kernel above that bound is instruction issue around the products, not
// bytes: the 256 ELUs per edge, the edge features (two norms and two
// projections per column pair), the TF32 splits in fp32, and the softmaxes
// and value sums after them. The neighbour rows (512 B fp32, 256 B bf16 per
// edge) come from L2 and overlap with the products.
//
// Design. A small kernel first computes every atom's first-layer term
// pa = [q_n, |p_n|] K0[1:65] + B0 (fp32, to scratch). Then one persistent
// block per SM walks tiles of TE edges (TE/nn whole atoms): TE = 64 with 256
// threads in fp32, TE = 128 with 512 threads in bf16. The block stages the
// edge-MLP weights in shared memory once per launch (timed on an H100 at
// 0.004 ms or less, so no layout is kept between launches), transposed to
// [n][k]: the 128-wide
// K0e block with an XOR swizzle, the others padded, so B fragments load
// without bank conflicts (ldmatrix.x4 in bf16, 8-byte loads in fp32); the
// zero blocks of K1 and K2 are neither stored nor multiplied, and the 3- and
// 9-column K2 blocks are padded to 8 and 16 columns. Per tile:
//   - its neighbour rows, centre rows and pa rows were copied into one of two
//     shared buffers by cp.async (16 B a thread) while the previous tile
//     computed (the ids one tile further ahead, so no copy waits on an id
//     load); d, r and nq came through registers;
//   - each warp takes 16 edges and half the columns: the warp with columns
//     0:64 of h0 and h1 runs the q and p MLPs, which end in the 12 logit
//     columns; the one with 64:128 the value MLP, which ends in V0 | V1.
//     With K1 and K2 block-diagonal, every product stays inside its warp,
//     and the two kinds share each scheduler. E is computed from the staged
//     rows straight into A fragments (each of p_m, p_n read once for the two
//     E regions that use it); the accumulator fragment of one m16n8 product
//     is the A fragment of the next, so h0 and h1 never leave the registers;
//     only out (76 columns) goes to shared memory;
//   - one thread per (edge, head) computes the logits and both softmaxes,
//     with segmented warp shuffles over the nn edges of an atom (nn = 64
//     pairs two warps);
//   - the value sums: every thread takes 4 columns of both heads of Zq or of
//     one x of Zp, over a slice of the atom's edges, the slices summed by
//     shuffles; p_m comes from the staged rows.
// The bf16 mode rounds the product inputs E, h0, h1 and out to bf16, as the
// TPU kernel rounds its stream between stages; everything else is fp32.
//
// fp32 scheme: 3xTF32, chosen because it keeps fp32 accuracy on the tensor
// cores: each operand x = hi + lo with hi = x rounded to TF32 and lo = x - hi
// (which the tensor core reads truncated to TF32), and a product is
// lo*hi + hi*lo + hi*hi on mma.m16n8k8.tf32 with fp32 accumulation. One TF32
// product keeps about three decimal digits, too few for the fp32 tolerance
// (tests/test_torch_edge_attention.py shows it) and for the model's 32
// layers. The split is done as fragments load, so the weights stay one fp32
// copy in shared memory. The fragment's k order is permuted (k slots t and
// t+4 hold columns 2t and 2t+1 of an 8-column group), so an accumulator
// fragment is an A fragment as it stands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S = 32;
constexpr int NH = 2;
constexpr int NK = 3;
constexpr int H = 4 * S;                   // packed hidden width, 128
constexpr int NOUT = NK + 3 * NK + 2 * S;  // 76
constexpr int OV0 = 4 * NK;                // V0 columns of out
constexpr int NQ = 2 * NH * NK;            // nq columns
constexpr int PAD = 8;                     // k pad of the [n][k] weights
constexpr int LDR = H + PAD;               // row stride of the staged qp rows
constexpr int LDV = 2 * S + 4;             // row stride of V0 | V1 in shared memory

template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int TE = 64; };
template <> struct Tile<__nv_bfloat16> { static constexpr int TE = 128; };

template <typename T>
struct Smem {
  static constexpr int TE = Tile<T>::TE;   // edges per tile
  static constexpr int MAXA = TE / 8;      // atoms per tile at nn = 8
  static constexpr int ROWS = TE + MAXA;   // neighbour rows, then centre rows
  static constexpr int META = 4 * TE + MAXA * NQ;  // d [TE], r [TE][3], nq [A][NQ]
  T k0e[H * H];  // [n][k], k swizzled (wi<H>)
  T k1q[S * (S + PAD)], k1p[S * (S + PAD)], k1v[2 * S * (2 * S + PAD)];
  T k2q[8 * (S + PAD)], k2p[16 * (S + PAD)], k2v[2 * S * (2 * S + PAD)];
  float k0d[H], b1[H], b2[NOUT];
  alignas(16) T rows[2][ROWS * LDR];
  float logit[OV0][TE];              // out = h1 K2 + B2: the 12 key columns,
  alignas(16) float val[TE * LDV];   // and V0 | V1 of the tile's edges
  alignas(16) float pa[2][MAXA][H];  // per-atom first-layer term, B0 included
  float meta[2][META];
  int ids[2][TE];             // neighbour ids of the tile staged next
  alignas(16) float w[TE][NH][4];         // normalised weights: q plane, c0, c1, c2
  float s2[MAXA][NH];
  float red[4 * TE / 32][8];  // per-warp partials of the nn = 64 softmax
};
static_assert(sizeof(Smem<float>) <= 232448, "fp32 tile exceeds 227 KB");
static_assert(sizeof(Smem<__nv_bfloat16>) <= 232448, "bf16 tile exceeds 227 KB");

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T fromf(float x);
template <> __device__ __forceinline__ float fromf<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 fromf<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T, kept in fp32
template <typename T> __device__ __forceinline__ float rnd(float x) { return tof(fromf<T>(x)); }
// elu with expm1(x) taken as exp(x) - 1: its absolute error, about 1e-7,
// is what the next product sees (the relative error near 0 is not). On an
// H100, expm1f made the whole kernel 32-49% slower and moved none of the
// errors chip_smoke.py measures.
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}
// |(x, y, z)| floored at 1e-18, as sqrt(s) = s * rsqrt(s) (relative error
// about 1e-7, a third of the instructions of an IEEE sqrtf, which cost the
// kernel 1-2% on an H100)
__device__ __forceinline__ float norm3(float x, float y, float z) {
  const float s = fmaxf(x * x + y * y + z * z, 1e-36f);
  return s * rsqrtf(s);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// ---- tensor-core products ---------------------------------------------------
//
// A C-layout tile x[4] holds the m16n8 accumulator fragment of this thread
// (g = lane / 4, q = lane % 4): x[0], x[1] at row g, columns 2q, 2q+1 of an
// 8-column group; x[2], x[3] at row g + 8. gemm() adds X Wt^T to acc, where X
// is KT such tiles (k = 8 KT) and Wt points at [n][k] weights (stride ldk)
// at the first output column and the first k.

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits), to nearest with
// ties away from zero, in two integer instructions (cvt.rna.tf32.f32 takes
// about ten on sm_90); lo = x - hi is exact in fp32 and goes to the tensor
// core as it is, which reads a TF32 operand's top 19 bits, i.e. truncates lo
// to 10 mantissa bits (|error| < 2^-21 |x|). Finite inputs only.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Index of weight (n, k) in an [n][k] array of row length LDK. The 128-wide
// K0e block is stored unpadded, with bits 3-5 of k XOR-ed by n % 8, so the
// B-fragment loads of 8 (fp32) or 4 (bf16) consecutive n stay off each
// other's banks; the narrower blocks are padded to LDK = K + 8 instead.
template <int LDK>
__device__ __forceinline__ int wi(int n, int k) {
  return LDK == H ? n * H + (k ^ ((n & 7) << 3)) : n * LDK + k;
}

// fp32: 3xTF32 on m16n8k8, one C tile per k step. k slot q of the fragment
// is column 2q of the group and slot q + 4 is column 2q + 1, in A and in B.
template <int LDK, int KT, int NT>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const float (&x)[KT][4], const float* wt,
                                     int n0, int k0, int g, int q) {
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    uint32_t ah[4], al[4];
    split(x[j][0], ah[0], al[0]);
    split(x[j][2], ah[1], al[1]);
    split(x[j][1], ah[2], al[2]);
    split(x[j][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 b = ld2(wt + wi<LDK>(n0 + 8 * n + g, k0 + 8 * j + 2 * q));
      uint32_t bh0, bl0, bh1, bl1;
      split(b.x, bh0, bl0);
      split(b.y, bh1, bl1);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
}

// bf16: m16n8k16, two C tiles per k step, operands rounded to bf16. The B
// fragments of two n tiles come from one ldmatrix.x4: lane l points at row
// n = 8 (l / 16) + l % 8, k = 8 ((l / 8) % 2) of the pair ([n][k] is the
// fragment layout of B).
template <int LDK, int KT, int NT>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const float (&x)[KT][4],
                                     const __nv_bfloat16* wt, int n0, int k0, int g, int q) {
  static_assert(KT % 2 == 0, "bf16 k steps take two C tiles");
#pragma unroll
  for (int s = 0; s < KT / 2; ++s) {
    const uint32_t a[4] = {pack_bf16(x[2 * s][0], x[2 * s][1]), pack_bf16(x[2 * s][2], x[2 * s][3]),
                           pack_bf16(x[2 * s + 1][0], x[2 * s + 1][1]),
                           pack_bf16(x[2 * s + 1][2], x[2 * s + 1][3])};
    const int lane = 4 * g + q, k = k0 + 16 * s + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int n = 0; n + 1 < NT; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, wt + wi<LDK>(n0 + 8 * n + 8 * (lane >> 4) + (lane & 7), k));
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
    if (NT % 2) {
      uint32_t b[2];
      ldsm_x2(b, wt + wi<LDK>(n0 + 8 * (NT - 1) + (lane & 7), k));
      mma_bf16(acc[NT - 1], a, b[0], b[1]);
    }
  }
}

#define TILES(x, first, n) (*reinterpret_cast<float(*)[n][4]>(&(x)[first]))

// The edge features of columns c, c + 1 of all four 32-column regions
// (c even, c < S) of one edge (staged row R, centre row C, direction r),
// into x[region][u][2 rho], x[region][u][2 rho + 1]: each of p_m, p_n is
// read once for the two regions that use it.
template <int G, typename T>
__device__ __forceinline__ void edge_feats(float (&x)[4][G][4], int u, int rho, const T* R, const T* C,
                                           const float* r, int c) {
  const float2 q = ld2(R + c);
  const float2 mx = ld2(R + S + c), my = ld2(R + 2 * S + c), mz = ld2(R + 3 * S + c);
  const float2 nx = ld2(C + S + c), ny = ld2(C + 2 * S + c), nz = ld2(C + 3 * S + c);
  float* v0 = &x[0][u][2 * rho];
  float* v1 = &x[1][u][2 * rho];
  float* v2 = &x[2][u][2 * rho];
  float* v3 = &x[3][u][2 * rho];
  v0[0] = q.x, v0[1] = q.y;
  v1[0] = norm3(mx.x, my.x, mz.x), v1[1] = norm3(mx.y, my.y, mz.y);
  v2[0] = nx.x * r[0] + ny.x * r[1] + nz.x * r[2], v2[1] = nx.y * r[0] + ny.y * r[1] + nz.y * r[2];
  v3[0] = mx.x * r[0] + my.x * r[1] + mz.x * r[2], v3[1] = mx.y * r[0] + my.y * r[1] + mz.y * r[2];
}

// dst[n][k] (index wi<LDK>) = src[k * lds + n] for k < K, n < NN, zero for
// n >= nvalid: a weight block transposed into shared memory. Each thread
// moves 16 bytes of one n (coalesced global reads across n).
template <int LDK, int K, int NN, typename T>
__device__ __forceinline__ void stage_weights(T* dst, const T* src, int lds, int nvalid, int t,
                                              int threads) {
  constexpr int V = 16 / (int)sizeof(T);
  for (int i = t; i < NN * K / V; i += threads) {
    const int n = i % NN, k = (i / NN) * V;
    alignas(16) T v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = n < nvalid ? src[(k + u) * lds + n] : fromf<T>(0.f);
    *reinterpret_cast<uint4*>(dst + wi<LDK>(n, k)) = *reinterpret_cast<const uint4*>(v);
  }
}

template <typename T>
struct Args {
  const T* qp;
  const int* ids;
  const T *dist, *rvec, *nq, *K0, *B0, *K1, *B1, *K2, *B2;
  T *zq, *zp;
  const float* pa;  // [N, H] per-atom first-layer terms (atom_term_kernel)
  int n_atoms, nn;
};

// Start the copies of tile `tile`'s neighbour rows (ids from sm.ids[buf]),
// centre rows and per-atom terms into buffer `buf` (cp.async, one commit
// group). Atoms past the end take row 0.
template <typename T>
__device__ __forceinline__ void stage_rows(const Args<T>& g, Smem<T>& sm, int tile, int buf, int t) {
  constexpr int TE = Smem<T>::TE, THREADS = 4 * TE;
  constexpr int CH = H * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int EL = 16 / (int)sizeof(T);
  constexpr int NC = (Smem<T>::ROWS * CH + THREADS - 1) / THREADS;
  const int A = TE / g.nn, a0 = tile * A;
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const int c = t + u * THREADS, row = c / CH, part = c % CH;
    if (row < TE + A) {
      const int src = row < TE ? sm.ids[buf][row] : (a0 + row - TE < g.n_atoms ? a0 + row - TE : 0);
      cp_async16(sm.rows[buf] + row * LDR + part * EL, g.qp + (size_t)src * H + part * EL);
    }
  }
  for (int c = t; c < A * H / 4; c += THREADS) {
    const int a = c / (H / 4), part = c % (H / 4), atom = a0 + a < g.n_atoms ? a0 + a : 0;
    cp_async16(&sm.pa[buf][a][4 * part], g.pa + (size_t)atom * H + 4 * part);
  }
  cp_async_commit();
}

// Neighbour id e of tile `tile`; 0 past the end.
template <typename T>
__device__ __forceinline__ int id_at(const Args<T>& g, int tile, int ntiles, int e) {
  const int A = Smem<T>::TE / g.nn, a0 = tile * A;
  return tile < ntiles && a0 + e / g.nn < g.n_atoms ? g.ids[(size_t)a0 * g.nn + e] : 0;
}

// Entry m of tile `tile`'s flat meta block: d [TE], r [TE][3], nq [A][NQ];
// zero past the end.
template <typename T>
__device__ __forceinline__ float meta_at(const Args<T>& g, int tile, int m) {
  constexpr int TE = Smem<T>::TE;
  const int A = TE / g.nn, a0 = tile * A;
  if (m < TE) return a0 + m / g.nn < g.n_atoms ? tof(g.dist[(size_t)a0 * g.nn + m]) : 0.f;
  m -= TE;
  if (m < 3 * TE) return a0 + m / (3 * g.nn) < g.n_atoms ? tof(g.rvec[(size_t)a0 * g.nn * 3 + m]) : 0.f;
  m -= 3 * TE;
  if (m < A * NQ) return a0 + m / NQ < g.n_atoms ? tof(g.nq[(size_t)a0 * NQ + m]) : 0.f;
  return 0.f;
}

template <typename T>
__global__ void __launch_bounds__(4 * Tile<T>::TE, 1) edge_attention_kernel(const Args<T> g) {
  using SM = Smem<T>;
  constexpr int TE = SM::TE, THREADS = 4 * TE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SM& sm = *reinterpret_cast<SM*>(smem_raw);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gq = lane >> 2, q = lane & 3;
  const int nn = g.nn, lg = __ffs(nn) - 1, A = TE >> lg;
  const int ntiles = (g.n_atoms + A - 1) / A;
  int tile = blockIdx.x;
  if (tile >= ntiles) return;

  // ---- the first tile's rows and meta; the weights, once per block -------
  if (t < TE) {
    sm.ids[0][t] = id_at(g, tile, ntiles, t);
    sm.ids[1][t] = id_at(g, tile + gridDim.x, ntiles, t);
  }
  __syncthreads();
  stage_rows(g, sm, tile, 0, t);
  for (int m = t; m < SM::META; m += THREADS) sm.meta[0][m] = meta_at(g, tile, m);
  stage_weights<H, H, H>(sm.k0e, g.K0 + (1 + 2 * S) * H, H, H, t, THREADS);
  stage_weights<S + PAD, S, S>(sm.k1q, g.K1, H, S, t, THREADS);
  stage_weights<S + PAD, S, S>(sm.k1p, g.K1 + S * H + S, H, S, t, THREADS);
  stage_weights<2 * S + PAD, 2 * S, 2 * S>(sm.k1v, g.K1 + 2 * S * H + 2 * S, H, 2 * S, t, THREADS);
  stage_weights<S + PAD, S, 8>(sm.k2q, g.K2, NOUT, NK, t, THREADS);
  stage_weights<S + PAD, S, 16>(sm.k2p, g.K2 + S * NOUT + NK, NOUT, 3 * NK, t, THREADS);
  stage_weights<2 * S + PAD, 2 * S, 2 * S>(sm.k2v, g.K2 + 2 * S * NOUT + OV0, NOUT, 2 * S, t, THREADS);
  for (int i = t; i < H; i += THREADS) {
    sm.k0d[i] = tof(g.K0[i]);
    sm.b1[i] = tof(g.B1[i]);
  }
  for (int i = t; i < NOUT; i += THREADS) sm.b2[i] = tof(g.B2[i]);

  const float rsdk = 1.f / sqrtf((float)NK);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int b = it & 1, a0 = tile * A, next = tile + gridDim.x;
    cp_async_wait_all();
    __syncthreads();  // this tile's rows and meta are in; the last tile is done

    // ---- the next tile's rows, by cp.async into the other buffer; the ids
    // of the tile after it, through a register --------------------------------
    if (next < ntiles) stage_rows(g, sm, next, b ^ 1, t);
    const int idv = t < TE ? id_at(g, next + gridDim.x, ntiles, t) : 0;

    const T* rows = sm.rows[b];
    const float* meta = sm.meta[b];
    const float(*pa)[H] = sm.pa[b];

    // ---- 1. the edge MLP on the tensor cores: 16 edges, half the columns --
    {
      // warps w and w + 4 share a scheduler (w % 4): one of each half there
      const int half = (warp >> 2) & 1, col0 = 64 * half;
      const int e0 = 16 * ((warp & 3) | ((warp >> 3) << 2)) + gq, e1 = e0 + 8;
      const int at0 = e0 >> lg, at1 = e1 >> lg;
      const T* R0 = rows + e0 * LDR;
      const T* R1 = rows + e1 * LDR;
      const T* C0 = rows + (TE + at0) * LDR;
      const T* C1 = rows + (TE + at1) * LDR;
      const float* r0 = meta + TE + 3 * e0;
      const float* r1 = meta + TE + 3 * e1;

      // h0 = elu(E K0e + d K0[0] + pa); E straight from the staged rows, the
      // same 8 (fp32) or 16 (bf16) columns of each of its four regions a step
      constexpr int G = sizeof(T) == 4 ? 1 : 2;  // 8-column groups per k step
      float h[8][4] = {};
#pragma unroll 1
      for (int sg = 0; sg < S / 8; sg += G) {
        float x[4][G][4];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          edge_feats(x, u, 0, R0, C0, r0, 8 * (sg + u) + 2 * q);
          edge_feats(x, u, 1, R1, C1, r1, 8 * (sg + u) + 2 * q);
        }
#pragma unroll
        for (int region = 0; region < 4; ++region)
          gemm<H>(h, x[region], sm.k0e, col0, region * S + 8 * sg, gq, q);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? e0 : e1, col = col0 + 8 * j + 2 * q + (i & 1);
          h[j][i] = elu(h[j][i] + meta[row] * sm.k0d[col] + pa[i < 2 ? at0 : at1][col]);
        }

      // h1 = elu(h0 K1 + B1): the q and p blocks (half 0) or the v block
      float h1[8][4] = {};
      if (half == 0) {
        gemm<S + PAD>(TILES(h1, 0, 4), TILES(h, 0, 4), sm.k1q, 0, 0, gq, q);
        gemm<S + PAD>(TILES(h1, 4, 4), TILES(h, 4, 4), sm.k1p, 0, 0, gq, q);
      } else {
        gemm<2 * S + PAD>(h1, h, sm.k1v, 0, 0, gq, q);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) h1[j][i] = elu(h1[j][i] + sm.b1[col0 + 8 * j + 2 * q + (i & 1)]);

      // out = h1 K2 + B2 -> shared memory, rounded to T
      if (half == 0) {
        float oq[1][4] = {}, op[2][4] = {};
        gemm<S + PAD>(oq, TILES(h1, 0, 4), sm.k2q, 0, 0, gq, q);
        gemm<S + PAD>(op, TILES(h1, 4, 4), sm.k2p, 0, 0, gq, q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 2 * q + (i & 1);
          if (n < NK) sm.logit[n][i < 2 ? e0 : e1] = rnd<T>(oq[0][i] + sm.b2[n]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 8 * j + 2 * q + (i & 1);
            if (n < 3 * NK) sm.logit[NK + n][i < 2 ? e0 : e1] = rnd<T>(op[j][i] + sm.b2[NK + n]);
          }
      } else {
        float ov[8][4] = {};
        gemm<2 * S + PAD>(ov, h1, sm.k2v, 0, 0, gq, q);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 8 * j + 2 * q + (i & 1);
            sm.val[(i < 2 ? e0 : e1) * LDV + n] = rnd<T>(ov[j][i] + sm.b2[OV0 + n]);
          }
      }
    }
    __syncthreads();

    // ---- the next tile's meta, through registers ---------------------------
    float mv[2] = {0.f, 0.f};
    if (next < ntiles) {
      mv[0] = meta_at(g, next, t);
      mv[1] = meta_at(g, next, t + THREADS);
    }

    // ---- 2. softmaxes: one thread per (edge, head) -------------------------
    {
      const bool active = t < NH * TE;
      const int hh = active ? t / TE : 0, e = t % TE, a = e >> lg;
      float l[4] = {0.f, 0.f, 0.f, 0.f};
      if (active) {
        const float* nqa = meta + 4 * TE + a * NQ;
        float v = 0.f;
        for (int k = 0; k < NK; ++k) v += nqa[hh * NK + k] * sm.logit[k][e];
        l[0] = v * rsdk;
        for (int c = 0; c < 3; ++c) {
          v = 0.f;
          for (int k = 0; k < NK; ++k) v += nqa[NH * NK + hh * NK + k] * sm.logit[NK + c * NK + k][e];
          l[1 + c] = v * rsdk;
        }
      }
      // segmented reductions over the nn edges of an atom: lanes for
      // nn <= 32, two warps for nn = 64
      const int width = nn < 32 ? nn : 32;
      float mq = l[0], mp = fmaxf(l[1], fmaxf(l[2], l[3]));
      for (int o = 1; o < width; o <<= 1) {
        mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, o));
        mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, o));
      }
      if (nn > 32) {
        if (lane == 0) sm.red[warp][0] = mq, sm.red[warp][1] = mp;
        __syncthreads();
        mq = fmaxf(mq, sm.red[warp ^ 1][0]);
        mp = fmaxf(mp, sm.red[warp ^ 1][1]);
      }
      float ex[4];
      ex[0] = expf(l[0] - mq);
      for (int c = 1; c < 4; ++c) ex[c] = expf(l[c] - mp);
      float sq = ex[0], sp = ex[1] + ex[2] + ex[3], se2 = ex[2];
      for (int o = 1; o < width; o <<= 1) {
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
        sp += __shfl_xor_sync(0xffffffffu, sp, o);
        se2 += __shfl_xor_sync(0xffffffffu, se2, o);
      }
      if (nn > 32) {
        if (lane == 0) sm.red[warp][2] = sq, sm.red[warp][3] = sp, sm.red[warp][4] = se2;
        __syncthreads();
        sq += sm.red[warp ^ 1][2];
        sp += sm.red[warp ^ 1][3];
        se2 += sm.red[warp ^ 1][4];
      }
      if (active) {
        float* w = sm.w[e][hh];
        const float iq = 1.f / sq, ip = 1.f / sp;
        w[0] = ex[0] * iq;
        for (int c = 1; c < 4; ++c) w[c] = ex[c] * ip;
        if ((e & (nn - 1)) == 0) sm.s2[a][hh] = se2 * ip;
      }
    }
    __syncthreads();

    // ---- 3. value sums: 4 columns s of both heads a thread ------------------
    {
      // item k of an atom: k < 8 takes Zq[., s], s = 4k..4k+3; k >= 8 takes
      // Zp[x, ., s], x = (k - 8) / 8. SL = nn / 8 neighbouring lanes share an
      // item, slice sl summing edges sl, sl + SL, ... (neighbouring rows, off
      // each other's banks): A * 32 * SL = 4 TE items and slices, one a thread.
      const int lsl = lg - 3, item = t >> lsl, sl = t & ((1 << lsl) - 1);
      const int a = item >> 5, k = item & 31, s = 4 * (k & 7), x = (k >> 3) - 1;
      const int e1 = (a + 1) << lg;
      float4 z0 = make_float4(0.f, 0.f, 0.f, 0.f), z1 = z0;
      if (x < 0) {
        for (int e = (a << lg) + sl; e < e1; e += 1 << lsl) {
          const float w0 = sm.w[e][0][0], w1 = sm.w[e][1][0];
          const float4 v = ld4(sm.val + e * LDV + s);
          z0 = make_float4(fmaf(w0, v.x, z0.x), fmaf(w0, v.y, z0.y), fmaf(w0, v.z, z0.z), fmaf(w0, v.w, z0.w));
          z1 = make_float4(fmaf(w1, v.x, z1.x), fmaf(w1, v.y, z1.y), fmaf(w1, v.z, z1.z), fmaf(w1, v.w, z1.w));
        }
      } else {
        for (int e = (a << lg) + sl; e < e1; e += 1 << lsl) {
          const float4 w0 = ld4(sm.w[e][0]), w1 = ld4(sm.w[e][1]);
          const float rx = meta[TE + 3 * e + x], u0 = w0.y * rx, u1 = w1.y * rx;
          const float4 v = ld4(sm.val + e * LDV + S + s), p = ld4(rows + e * LDR + S + x * S + s);
          z0 = make_float4(fmaf(w0.w, p.x, fmaf(u0, v.x, z0.x)), fmaf(w0.w, p.y, fmaf(u0, v.y, z0.y)),
                           fmaf(w0.w, p.z, fmaf(u0, v.z, z0.z)), fmaf(w0.w, p.w, fmaf(u0, v.w, z0.w)));
          z1 = make_float4(fmaf(w1.w, p.x, fmaf(u1, v.x, z1.x)), fmaf(w1.w, p.y, fmaf(u1, v.y, z1.y)),
                           fmaf(w1.w, p.z, fmaf(u1, v.z, z1.z)), fmaf(w1.w, p.w, fmaf(u1, v.w, z1.w)));
        }
      }
      for (int m = 1; m < (1 << lsl); m <<= 1) {
        z0.x += __shfl_xor_sync(0xffffffffu, z0.x, m);
        z0.y += __shfl_xor_sync(0xffffffffu, z0.y, m);
        z0.z += __shfl_xor_sync(0xffffffffu, z0.z, m);
        z0.w += __shfl_xor_sync(0xffffffffu, z0.w, m);
        z1.x += __shfl_xor_sync(0xffffffffu, z1.x, m);
        z1.y += __shfl_xor_sync(0xffffffffu, z1.y, m);
        z1.z += __shfl_xor_sync(0xffffffffu, z1.z, m);
        z1.w += __shfl_xor_sync(0xffffffffu, z1.w, m);
      }
      const int atom = a0 + a;
      if (sl == 0 && atom < g.n_atoms) {
        if (x < 0) {
          st4(g.zq + (size_t)atom * NH * S + s, z0);
          st4(g.zq + (size_t)atom * NH * S + S + s, z1);
        } else {
          const float4 p = ld4(rows + (TE + a) * LDR + S + x * S + s);
          const float s0 = sm.s2[a][0], s1 = sm.s2[a][1];
          T* out = g.zp + (size_t)atom * 3 * NH * S + x * NH * S + s;
          st4(out, make_float4(fmaf(s0, p.x, z0.x), fmaf(s0, p.y, z0.y), fmaf(s0, p.z, z0.z), fmaf(s0, p.w, z0.w)));
          st4(out + S, make_float4(fmaf(s1, p.x, z1.x), fmaf(s1, p.y, z1.y), fmaf(s1, p.z, z1.z), fmaf(s1, p.w, z1.w)));
        }
      }
    }
    if (next < ntiles) {
      sm.meta[b ^ 1][t] = mv[0];
      if (t + THREADS < SM::META) sm.meta[b ^ 1][t + THREADS] = mv[1];
    }
    if (t < TE) sm.ids[b][t] = idv;
  }
}

// pa[n] = [q_n, |p_n|] K0[1:2S+1] + B0 for every atom, fp32: the per-atom
// part of the first edge-MLP layer, 2 * 64 * 128 FLOP per atom. A block of
// 128 threads takes 32 atoms; thread c owns column c.
constexpr int AT = 32;

template <typename T>
__global__ void __launch_bounds__(H) atom_term_kernel(const Args<T> g, float* __restrict__ pa) {
  __shared__ __align__(16) float xn[2 * S][AT];  // [s][atom]: 16-byte reads of 4 atoms
  const int c = threadIdx.x, a0 = blockIdx.x * AT;
  for (int i = c; i < AT * 2 * S; i += H) {
    const int a = i % AT, s = i / AT;
    float v = 0.f;
    if (a0 + a < g.n_atoms) {
      const T* row = g.qp + (size_t)(a0 + a) * H;
      v = s < S ? tof(row[s]) : norm3(tof(row[s]), tof(row[S + s]), tof(row[2 * S + s]));
    }
    xn[s][a] = v;
  }
  __syncthreads();
  float k[2 * S], acc[AT] = {};
#pragma unroll
  for (int s = 0; s < 2 * S; ++s) k[s] = tof(g.K0[(1 + s) * H + c]);  // all loads in flight
#pragma unroll
  for (int s = 0; s < 2 * S; ++s)
#pragma unroll
    for (int a = 0; a < AT; ++a) acc[a] = fmaf(xn[s][a], k[s], acc[a]);
  const float b = tof(g.B0[c]);
#pragma unroll
  for (int a = 0; a < AT; ++a)
    if (a0 + a < g.n_atoms) pa[(size_t)(a0 + a) * H + c] = acc[a] + b;
}

template <typename T>
int launch(Args<T> args, float* pa, cudaStream_t stream) {
  constexpr int TE = Tile<T>::TE;
  auto kern = edge_attention_kernel<T>;
  const int smem = (int)sizeof(Smem<T>);
  // blocks that fit each card at once, set up on the first launch there
  static int grid_cap[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 4 * TE, smem);
    grid_cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  atom_term_kernel<T><<<(args.n_atoms + AT - 1) / AT, H, 0, stream>>>(args, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  args.pa = pa;
  const int A = TE / args.nn, ntiles = (args.n_atoms + A - 1) / A;
  kern<<<ntiles < grid_cap[dev] ? ntiles : grid_cap[dev], 4 * TE, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_as(const void* qp, const void* ids, const void* d, const void* r, const void* nq,
              const void* K0, const void* B0, const void* K1, const void* B1, const void* K2,
              const void* B2, void* zq, void* zp, void* pa, int n_atoms, int nn,
              cudaStream_t stream) {
  const Args<T> args{static_cast<const T*>(qp), static_cast<const int*>(ids),
                     static_cast<const T*>(d),  static_cast<const T*>(r),
                     static_cast<const T*>(nq), static_cast<const T*>(K0),
                     static_cast<const T*>(B0), static_cast<const T*>(K1),
                     static_cast<const T*>(B1), static_cast<const T*>(K2),
                     static_cast<const T*>(B2), static_cast<T*>(zq),
                     static_cast<T*>(zp),       nullptr,
                     n_atoms,                   nn};
  return launch(args, static_cast<float*>(pa), stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every floating input and both outputs).
// nn must be 8, 16, 32 or 64 (it divides the edge tile). pa is fp32 scratch
// of n_atoms x 128. qp and pa must be 16-byte aligned (their rows are copied
// 16 bytes at a time).
extern "C" int edge_attention(int dtype, const void* qp, const void* ids, const void* d,
                              const void* r, const void* nq, const void* K0, const void* B0,
                              const void* K1, const void* B1, const void* K2, const void* B2,
                              void* zq, void* zp, void* pa, int n_atoms, int nn, void* stream) {
  if (n_atoms <= 0) return 0;
  if (nn != 8 && nn != 16 && nn != 32 && nn != 64) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qp) % 16 != 0 || reinterpret_cast<uintptr_t>(pa) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_as<float>(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, zq, zp, pa, n_atoms, nn, s);
  if (dtype == 1)
    return launch_as<__nv_bfloat16>(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, zq, zp, pa, n_atoms,
                                    nn, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
