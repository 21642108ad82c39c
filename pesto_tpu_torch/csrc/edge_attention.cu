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
// every [N, nn, *] intermediate stay on chip. qp may be a larger table of
// which the N atoms are the rows row0 .. row0 + N (one shard of a structure
// whose atoms are split across devices, each with the whole state table),
// as the TPU kernel takes the atoms' own q and p apart from the neighbour
// rows it is given (geometric_pallas.py:257-270).
//
// Bound on the H100: the three edge-MLP products, 2 * (128*128 + 2*32*32 +
// 64*64 + 32*3 + 32*9 + 64*64) = 54,016 FLOP per edge with the
// block-diagonal structure, 97% of the work. They run on the tensor cores,
// so the bound is the tensor-core rate: bf16 operands at 989 TFLOP/s; fp32
// as three TF32 products at 495 TFLOP/s (0.175 ms at N = 8192, nn = 64,
// against 0.432 ms for fp32 FMA on the CUDA cores). Around the products
// each edge takes 256 ELUs (an ex2 each, at 16 a clock per SM: about a
// fifth of the fp32 products' time), its edge features (two norms and two
// projections per column pair), and its share of the softmaxes and value
// sums; the neighbour rows (512 B fp32, 256 B bf16 per edge) come from L2.
//
// Both dtypes launch two kernels: atom_term_kernel computes every atom's
// first-layer term pa = [q_n, |p_n|] K0[1:65] + B0 (fp32, to scratch), then
// one persistent tile kernel per SM walks tiles of whole atoms. The two
// dtypes' tile kernels share no product code: what suits one, the other
// cannot use.
//
// fp32 (wg::edge_attention_kernel): 3xTF32 on warpgroup MMA.
//   - arithmetic: each operand x = hi + lo, hi = x rounded to TF32 (to
//     nearest, ties away from zero), lo = x - hi, which the tensor core reads
//     truncated to TF32 (|error| < 2^-21 |x|); a product is
//     lo*hi + hi*lo + hi*hi with fp32 accumulation. One TF32 product keeps
//     about three decimal digits, too few for the fp32 tolerance
//     (tests/test_torch_edge_attention.py shows it) and the model's 32
//     layers.
//   - the weights are split once per launch, by 27 extra blocks of
//     atom_term_kernel's grid, into the scratch after pa: 27 slabs of 8 KB
//     (216 KB), in the order the products read them, each k step's hi and
//     lo in wgmma's K-major layout without swizzle (split_source). The tile
//     kernel streams them through a ring of 11 slabs in shared memory by
//     bulk copies on mbarriers; every block reads the same 216 KB, which
//     stays in L2: 1.7 KB an edge, about 1.6 TB/s at 0.54 ms for N = 8192,
//     nn = 64. The last of a block's 8 warps to be done with a slab refills
//     its slot, so no warp is spent on producing. The product loop splits
//     no weight: a k step's B is a descriptor, computed once per slab and
//     moved along it by adding 16-byte units.
//   - two warpgroups per block, each with its own tiles of TE = 64 edges
//     (64 / nn whole atoms; nn = 64 is one atom), running the three
//     products as M = 64 wgmma (m64nNk8.tf32, A from registers, B from the
//     ring): h0 on N = 128, h1 and out block by block on N = 32, 32, 64 and
//     8, 16, 64 (K2's 3 and 9 columns padded). The two meet only at the
//     ring, where they read the same slabs.
//   - the fused chain: a warp's 16 rows of a wgmma accumulator have the
//     m16n8 C layout, which is the A register layout once the k order of each
//     8-column group is permuted (slot t holds column 2t, slot t + 4 column
//     2t + 1); the split weights are stored in that k order, so h0 and h1
//     never leave the registers. wgmma is asynchronous and one group stays
//     in flight while the next is prepared: h0's groups are two k steps (so
//     the ring holds three groups' slabs beyond the two in flight), the next
//     8 columns' edge features computed under them; h1's and out's are four,
//     with the elu and split of the next four under them.
//   - rows: a warpgroup's neighbour rows, centre rows and pa rows are copied
//     by 16-byte cp.async into its one row buffer as soon as its E is in the
//     registers, so the copy runs under h1, out, the softmaxes and the value
//     sums, which read p_m and p_n again from L2.
//   - out (76 columns) goes to shared memory; one thread per (edge, head)
//     takes the softmaxes (segmented shuffles, nn = 64 pairing two warps),
//     and the value sums take 4 columns of both heads an item, 2 items a
//     thread, behind the warpgroup's own barrier (bar.sync 1 + warpgroup).
//   Shared memory: the ring 88 KB, the row buffers 2 x 38.3 KB, out 2 x 20
//   KB, pa 2 x 4 KB, the rest 12.4 KB: 230,272 of 232,448 bytes.
//   What holds it above the bound (0.54 ms against 0.175 at N = 8192, nn =
//   64, on an H100): not the tensor cores, which run tf32 wgmma at their
//   full rate at every N used here (at N = 32, 70% of it with A recomputed
//   in registers before each group, two warpgroups), but the warps' own
//   instruction streams around the products (elu, splits, edge features,
//   softmaxes, value sums; some 2,500 instructions a thread a tile by the
//   source), at two warps per scheduler: thread 0 spends about a quarter of
//   a tile in wgmma waits. Cutting elu from eight instructions to four took
//   10% off; moving the softmaxes and value sums under the next tile's
//   products, or starting the two warpgroups apart, took nothing.
//
// bf16 (edge_attention_kernel<__nv_bfloat16>): TE = 128 edges a tile, 512
// threads. The block stages the edge-MLP weights in shared memory once per
// launch (0.004 ms or less on an H100, so no layout is kept between
// launches), transposed to [n][k]: the 128-wide K0e block with an XOR
// swizzle, the others padded, so B fragments load by ldmatrix.x4 without
// bank conflicts; the zero blocks of K1 and K2 are neither stored nor
// multiplied, and the 3- and 9-column K2 blocks are padded to 8 and 16
// columns. Per tile:
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
//     E regions that use it); the accumulator fragment of one m16n8k16
//     product is the A fragment of the next, so h0 and h1 never leave the
//     registers; only out (76 columns) goes to shared memory;
//   - one thread per (edge, head) computes the logits and both softmaxes,
//     with segmented warp shuffles over the nn edges of an atom (nn = 64
//     pairs two warps);
//   - the value sums: every thread takes 4 columns of both heads of Zq or of
//     one x of Zp, over a slice of the atom's edges, the slices summed by
//     shuffles; p_m comes from the staged rows.
// The bf16 mode rounds the product inputs E, h0, h1 and out to bf16, as the
// TPU kernel rounds its stream between stages; everything else is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
static_assert(sizeof(Smem<__nv_bfloat16>) <= 232448, "bf16 tile exceeds 227 KB");

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T fromf(float x);
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

// mbarriers and bulk copies (TMA): a copy of `bytes` (a multiple of 16,
// 16-byte aligned) from device to shared memory that adds its bytes to an
// mbarrier's transaction count as they land
__device__ __forceinline__ uint32_t su32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(su32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(su32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(su32(dst)), "l"(src), "r"(bytes), "r"(su32(bar)) : "memory");
}
// the named barrier of the 128 threads of warpgroup id - 1
__device__ __forceinline__ void sync_group(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// ---- tensor-core products ---------------------------------------------------
//
// A C-layout tile x[4] holds the m16n8 accumulator fragment of this thread
// (g = lane / 4, q = lane % 4): x[0], x[1] at row g, columns 2q, 2q+1 of an
// 8-column group; x[2], x[3] at row g + 8. gemm() adds X Wt^T to acc, where X
// is KT such tiles (k = 8 KT) and Wt points at [n][k] weights (stride ldk)
// at the first output column and the first k.

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
// K0e block is stored unpadded, with bits 3-5 of k XOR-ed by n % 8, so the 8
// rows (consecutive n at one k) of an ldmatrix stay off each other's banks;
// the narrower blocks are padded to LDK = K + 8 instead.
template <int LDK>
__device__ __forceinline__ int wi(int n, int k) {
  return LDK == H ? n * H + (k ^ ((n & 7) << 3)) : n * LDK + k;
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
  int row0;         // the atoms' own rows are qp rows row0 .. row0 + n_atoms
};

// Start the copies of tile `tile`'s neighbour rows (ids from sm.ids[buf]),
// centre rows (qp row row0 + atom) and per-atom terms into buffer `buf`
// (cp.async, one commit group). Atoms past the end take qp row 0.
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
      const int src = row < TE ? sm.ids[buf][row]
                               : (a0 + row - TE < g.n_atoms ? g.row0 + a0 + row - TE : 0);
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

// ---- fp32: 3xTF32 on warpgroup MMA ------------------------------------------
//
// The design is in the note at the top. Names here are the fp32 kernel's own;
// nothing of its products is shared with the bf16 kernel above.
namespace wg {

constexpr int TE = 64;                     // edges per warpgroup tile
constexpr int THREADS = 256;               // two warpgroups
constexpr int MAXA = TE / 8;               // atoms per tile at nn = 8
constexpr int ROWS = TE + MAXA;            // neighbour rows, then centre rows
constexpr int META = 4 * TE + MAXA * NQ;   // d [TE], r [TE][3], nq [A][NQ]
constexpr int MV = (META + 127) / 128;     // meta entries a thread carries to the next tile
constexpr int SLAB = 2048;                 // floats of one weight slab (8 KB)
constexpr int NSLAB = 27;                  // slabs of one pass over the split weights
constexpr int RING = 11;                   // slabs in shared memory at once
constexpr int SPLIT_FLOATS = NSLAB * SLAB; // the split weights after pa in the scratch
static_assert(SPLIT_FLOATS == 55296, "ops/edge_attention.py allocates this much scratch");

struct Smem {
  alignas(128) float ring[RING][SLAB];       // weight slabs, hi then lo of each k step
  alignas(16) float rows[2][ROWS * LDR];     // per warpgroup: the staged qp rows
  alignas(16) float pa[2][MAXA][H];          // per-atom first-layer terms, B0 included
  alignas(16) float meta[2][2][META];        // [warpgroup][tile parity]
  float logit[2][OV0][TE];                   // out = h1 K2 + B2: the 12 key columns,
  alignas(16) float val[2][TE * LDV];        // and V0 | V1 of the tile's edges
  alignas(16) float w[2][TE][NH][4];         // normalised weights: q plane, c0, c1, c2
  float s2[2][MAXA][NH];
  float red[2][4][8];                        // per-warp partials of the nn = 64 softmax
  float k0d[H], b1[H], b2[NOUT];
  int ids[2][2][TE];                         // [warpgroup][tile parity]: neighbour ids
  unsigned long long full[RING];             // a slab has landed
  unsigned cnt[RING];                        // warps done with a slot, over all its uses
};
static_assert(sizeof(Smem) <= 232448, "fp32 tile exceeds 227 KB");

// Where word i of slab s of the split weights comes from: the value of the
// weight it holds (0 for padding) and whether the word is its lo part. A
// slab holds whole k steps; a k step of N output columns is N * 8 hi words,
// then N * 8 lo words, in wgmma's K-major core matrices: word
// ((2 ng + h) * 8 + n8) * 4 + e is column 8 ng + n8 at k slot 4 h + e, and k
// slot t holds source row k0 + 2t (t < 4) or k0 + 2t - 7 (t >= 4), the
// order in which the accumulator fragments of the product before it are
// read as A fragments. The slabs, in the order the products read them:
//   0-15   h0 = E K0e: k step kk = 4 sg + region covers E columns
//          32 region + 8 sg .. + 8, N = 128, one a slab;
//   16, 17 h1 = h0 K1, the q and p blocks: k steps 0-3 and 4-7, N = 32;
//   18-21  the v block: k steps 8-15, N = 64, two a slab;
//   22     out = h1 K2, the q block (k steps 0-3, N = 8, 3 valid), the p
//          block (4-7, N = 16, 9 valid), then 512 words of padding;
//   23-26  the v block: k steps 8-15, N = 64, two a slab.
// In h1 and out, k step j reads columns 8 j .. 8 j + 8 of the product before.
__device__ __forceinline__ float split_source(const Args<float>& g, int s, int i, bool& lo) {
  const float* w;
  int ld, k0, col0, n, nvalid, o;
  if (s < 16) {
    w = g.K0 + (1 + 2 * S) * H, ld = H, k0 = 32 * (s & 3) + 8 * (s >> 2), col0 = 0, n = H, nvalid = H, o = i;
  } else if (s < 22) {
    const int j = s < 18 ? 4 * (s - 16) + i / 512 : 8 + 2 * (s - 18) + i / 1024;
    w = g.K1, ld = H, k0 = 8 * j, col0 = j < 4 ? 0 : j < 8 ? S : 2 * S;
    n = nvalid = j < 8 ? S : 2 * S;
    o = j < 8 ? i % 512 : i % 1024;
  } else {
    lo = false;
    if (s == 22 && i >= 1536) return 0.f;
    const int j = s == 22 ? (i < 512 ? i / 128 : 4 + (i - 512) / 256) : 8 + 2 * (s - 23) + i / 1024;
    w = g.K2, ld = NOUT, k0 = 8 * j, col0 = j < 4 ? 0 : j < 8 ? NK : OV0;
    n = j < 4 ? 8 : j < 8 ? 16 : 2 * S;
    nvalid = j < 4 ? NK : j < 8 ? 3 * NK : 2 * S;
    o = s == 22 ? (i < 512 ? i % 128 : (i - 512) % 256) : i % 1024;
  }
  lo = o >= 8 * n;
  const int c = o % (8 * n), col = 8 * (c / 64) + ((c / 4) & 7), t = 4 * ((c / 32) & 1) + (c & 3);
  const int k = k0 + (t < 4 ? 2 * t : 2 * t - 7);
  return col < nvalid ? w[(size_t)k * ld + col0 + col] : 0.f;
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits), to nearest with
// ties away from zero, in two integer instructions (cvt.rna.tf32.f32 takes
// about ten on sm_90); lo = x - hi is exact in fp32 and goes to the tensor
// core as it is, which reads a TF32 operand's top 19 bits, i.e. truncates lo
// to 10 mantissa bits (|error| < 2^-21 |x|). Finite inputs only.
__device__ __forceinline__ uint32_t tf32_hi(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// Slab s of the split weights, by one block of the pre-pass's grid.
__device__ __forceinline__ void split_slab(const Args<float>& g, int s, float* out) {
  for (int i = threadIdx.x; i < SLAB; i += blockDim.x) {
    bool lo;
    const float x = split_source(g, s, i, lo);
    const float hi = __uint_as_float(tf32_hi(x));
    out[(size_t)s * SLAB + i] = lo ? x - hi : hi;
  }
}

// wgmma: D (64 x N, fp32, the C layout of m16n8 per warp: d[4 j + i] is row
// g + 8 (i / 2), column 8 j + 2 q + i % 2 of the warp's 16 rows) += A B, A
// (64 x 8, tf32) from registers, B (8 x N, tf32) from shared memory by a
// descriptor; acc = 0 overwrites D.
template <int N> struct Wg;
template <>
struct Wg<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Wg<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Wg<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Wg<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Wg<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// elu with exp(x) taken as ex2.approx.ftz(x log2 e): four instructions
// against __expf's eight (which scales subnormal results instead of
// flushing them: only elu's -1 + exp(x) below -87 sees the difference, and
// loses it in the sum). 10% of the fp32 tile's time on an H100.
__device__ __forceinline__ float eluf(float x) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * 1.44269502f));
  return x > 0.f ? x : e - 1.f;
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers the compiler may not move across the asm statements around them
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The descriptor of a k step's B (N x 8, K-major, no swizzle) at p: core
// matrices of 8 columns by 16 bytes, the two k halves 128 B apart (leading
// byte offset), the 8-column groups 256 B apart (stride byte offset). Its
// low 14 bits are p's shared address in 16-byte units, so adding 16-byte
// units to it moves it along a slab.
__device__ __forceinline__ uint64_t bdesc(const float* p) {
  return (uint64_t)((su32(p) & 0x3ffff) >> 4) | (uint64_t)(128 >> 4) << 16 | (uint64_t)(256 >> 4) << 32;
}

// The A fragments of one k step, split into hi and lo, from x, the C-layout
// values of this thread at the step's 8 columns: slots a0 = (g, 2q),
// a1 = (g + 8, 2q), a2 = (g, 2q + 1), a3 = (g + 8, 2q + 1).
struct Frag {
  uint32_t hi[4], lo[4];
};
// the fragments of a group computed before its wgmma.fence
template <int K>
__device__ __forceinline__ void pinf(Frag (&a)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k].hi[i]), "+r"(a[k].lo[i])::"memory");
}
__device__ __forceinline__ Frag split_a(const float (&x)[4]) {
  const float v[4] = {x[0], x[2], x[1], x[3]};
  Frag a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.hi[i] = tf32_hi(v[i]);
    a.lo[i] = __float_as_uint(v[i] - __uint_as_float(a.hi[i]));
  }
  return a;
}

// One k step of 3xTF32: D += lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), bh the
// descriptor of B's hi, whose lo follows 8 N floats (2 N 16-byte units) on.
// Inside a wgmma group: the caller fences before the group's first step and
// commits after its last.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const Frag& a, uint64_t bh, bool acc) {
  const uint64_t bl = bh + 2 * N;
  Wg<N>::mma(d, a.lo, bh, acc);
  Wg<N>::mma(d, a.hi, bl, 1);
  Wg<N>::mma(d, a.hi, bh, 1);
}

#define PART(x, first, n) (*reinterpret_cast<float(*)[n]>(&(x)[first]))

// The weight ring: slab u of this block's stream (u = tile iteration * NSLAB
// + slab) sits in slot u % RING, in that slot's (u / RING)-th fill.
__device__ __forceinline__ const float* slab_wait(Smem& sm, int u) {
  mbar_wait(&sm.full[u % RING], (u / RING) & 1);
  return sm.ring[u % RING];
}
// This warp is done with slab u (its wgmma groups on it have completed); the
// last of the block's 8 warps to be done refills the slot with slab u + RING.
__device__ __forceinline__ void slab_done(Smem& sm, int u, int total, const float* split, int lane) {
  if (lane == 0) {
    const int slot = u % RING;
    if ((atomicAdd(&sm.cnt[slot], 1u) & 7u) == 7u && u + RING < total) {
      mbar_expect(&sm.full[slot], SLAB * 4);
      bulk_copy(sm.ring[slot], split + (size_t)((u + RING) % NSLAB) * SLAB, SLAB * 4, &sm.full[slot]);
    }
  }
  __syncwarp();
}

// Neighbour id e of warpgroup tile `tile` (nn = 2^lg); 0 past the end.
__device__ __forceinline__ int id_at(const Args<float>& g, int lg, int tile, int ntiles, int e) {
  const int a0 = tile << (6 - lg);
  return tile < ntiles && a0 + (e >> lg) < g.n_atoms ? g.ids[((size_t)a0 << lg) + e] : 0;
}

// Entry m of tile `tile`'s flat meta block: d [TE], r [TE][3], nq [A][NQ];
// zero past the end.
__device__ __forceinline__ float meta_at(const Args<float>& g, int lg, int tile, int m) {
  const int a0 = tile << (6 - lg);
  if (m < TE) return a0 + (m >> lg) < g.n_atoms ? g.dist[((size_t)a0 << lg) + m] : 0.f;
  m -= TE;
  if (m < 3 * TE) return a0 + ((m / 3) >> lg) < g.n_atoms ? g.rvec[((size_t)a0 << lg) * 3 + m] : 0.f;
  m -= 3 * TE;
  if (m < (NQ << (6 - lg))) return a0 + m / NQ < g.n_atoms ? g.nq[(size_t)a0 * NQ + m] : 0.f;
  return 0.f;
}

// Start the copies of warpgroup tile `tile`'s neighbour rows (ids from
// sm.ids[wgi][buf]), centre rows (qp row row0 + atom) and per-atom terms
// into the warpgroup's buffers (cp.async, one commit group). Atoms past the
// end take qp row 0.
__device__ __forceinline__ void stage_rows(const Args<float>& g, Smem& sm, int wgi, int lg, int tile, int buf,
                                           int t) {
  constexpr int CH = H / 4;  // 16-byte chunks per row
  const int A = TE >> lg, a0 = tile * A;
  float* rows = sm.rows[wgi];
  const int* ids = sm.ids[wgi][buf];
  for (int c = t; c < (TE + A) * CH; c += 128) {
    const int row = c / CH, part = c % CH;
    const int src = row < TE ? ids[row] : (a0 + row - TE < g.n_atoms ? g.row0 + a0 + row - TE : 0);
    cp_async16(rows + row * LDR + part * 4, g.qp + (size_t)src * H + part * 4);
  }
  for (int c = t; c < A * CH; c += 128) {
    const int a = c / CH, part = c % CH, atom = a0 + a < g.n_atoms ? a0 + a : 0;
    cp_async16(&sm.pa[wgi][a][4 * part], g.pa + (size_t)atom * H + 4 * part);
  }
  cp_async_commit();
}

// Where k step j (8 columns of the product before) of h1 and of out reads
// its B: the slab, the offset in it, and whether it is the slab's first or
// last k step (split_source lays them out).
__device__ constexpr int h1_slab(int j) { return j < 4 ? 16 : j < 8 ? 17 : 18 + (j - 8) / 2; }
__device__ constexpr int h1_off(int j) { return j < 8 ? (j & 3) * 512 : ((j - 8) & 1) * 1024; }
__device__ constexpr bool h1_first(int j) { return j < 8 ? (j & 3) == 0 : ((j - 8) & 1) == 0; }
__device__ constexpr bool h1_last(int j) { return j < 8 ? (j & 3) == 3 : ((j - 8) & 1) == 1; }
__device__ constexpr int out_slab(int j) { return j < 8 ? 22 : 23 + (j - 8) / 2; }
__device__ constexpr int out_off(int j) { return j < 4 ? 128 * j : j < 8 ? 512 + 256 * (j - 4) : ((j - 8) & 1) * 1024; }
__device__ constexpr bool out_first(int j) { return j == 0 || (j >= 8 && ((j - 8) & 1) == 0); }
__device__ constexpr bool out_last(int j) { return j == 7 || (j >= 8 && ((j - 8) & 1) == 1); }

// Each warpgroup (4 warps, 128 threads) walks its own tiles of TE edges:
// tile 2 (block + it * grid) + warpgroup at iteration it. Both warpgroups of
// a block run the same number of iterations (a tile past the end computes on
// stale rows and stores nothing), so each reads every weight slab once.
__global__ void __launch_bounds__(THREADS, 1) edge_attention_kernel(const Args<float> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, wgi = t >> 7, tw = t & 127, wq = tw >> 5, lane = t & 31;
  const int gq = lane >> 2, q = lane & 3, bar = 1 + wgi;
  const int nn = g.nn, lg = __ffs(nn) - 1, A = TE >> lg;
  const int ntiles = (g.n_atoms + A - 1) / A, npairs = (ntiles + 1) / 2;
  if ((int)blockIdx.x >= npairs) return;
  const int iters = (npairs - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = iters * NSLAB, step = 2 * gridDim.x;
  const float* split = g.pa + (size_t)g.n_atoms * H;
  int tile = 2 * blockIdx.x + wgi;

  // ---- the ring's barriers, the biases, the first tile's ids, rows, meta --
  if (t == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&sm.full[i], 1);
      sm.cnt[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tw < TE) {
    sm.ids[wgi][0][tw] = id_at(g, lg, tile, ntiles, tw);
    sm.ids[wgi][1][tw] = id_at(g, lg, tile + step, ntiles, tw);
  }
  for (int i = t; i < H; i += THREADS) {
    sm.k0d[i] = g.K0[i];
    sm.b1[i] = g.B1[i];
  }
  for (int i = t; i < NOUT; i += THREADS) sm.b2[i] = g.B2[i];
  for (int m = tw; m < META; m += 128) sm.meta[wgi][0][m] = meta_at(g, lg, tile, m);
  __syncthreads();
  if (t == 0)
    for (int u = 0; u < RING && u < total; ++u) {
      mbar_expect(&sm.full[u], SLAB * 4);
      bulk_copy(sm.ring[u], split + (size_t)(u % NSLAB) * SLAB, SLAB * 4, &sm.full[u]);
    }
  stage_rows(g, sm, wgi, lg, tile, 0, tw);

  const float rsdk = 1.f / sqrtf((float)NK);
  const float* rows = sm.rows[wgi];
  int idv = 0;  // ids of the tile after next, stored once this tile's are read
  for (int it = 0; it < iters; ++it, tile += step) {
    const int b = it & 1, a0 = tile * A, next = tile + step, ub = it * NSLAB;
    cp_async_wait_all();
    sync_group(bar);  // this tile's rows are in; the last tile is done
    if (it > 0 && tw < TE) sm.ids[wgi][b ^ 1][tw] = idv;
    const float* meta = sm.meta[wgi][b];
    const int* ids = sm.ids[wgi][b];

    // ---- 1. h0 = E K0e + d K0[0] + pa: E from the staged rows --------------
    // warp wq takes the warpgroup's rows 16 wq .. + 16: e0 = 16 wq + g, e1 = e0 + 8
    const int e0 = 16 * wq + gq, e1 = e0 + 8, at0 = e0 >> lg, at1 = e1 >> lg;
    float h0[64];
    {
      const float* R0 = rows + e0 * LDR;
      const float* R1 = rows + e1 * LDR;
      const float* C0 = rows + (TE + at0) * LDR;
      const float* C1 = rows + (TE + at1) * LDR;
      const float* r0 = meta + TE + 3 * e0;
      const float* r1 = meta + TE + 3 * e1;
      // k step kk = 4 sg + region: columns 8 sg + 2q, + 1 of E's region, rows
      // e0 and e1. A wgmma group is two k steps (the ring then holds the
      // slabs of three groups beyond the two in flight); the next sg's
      // features are computed while its second group runs.
      float x[4][1][4];
      edge_feats(x, 0, 0, R0, C0, r0, 2 * q);
      edge_feats(x, 0, 1, R1, C1, r1, 2 * q);
#pragma unroll
      for (int kk = 0; kk < 16; kk += 2) {
        Frag a[2];
        uint64_t bw[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i] = split_a(x[(kk + i) & 3][0]);
          bw[i] = bdesc(slab_wait(sm, ub + kk + i));
        }
        pinf(a);
        wg_fence();
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3<H>(h0, a[i], bw[i], kk + i > 0);
        wg_commit();
        if ((kk & 3) == 2 && kk < 14) {
          edge_feats(x, 0, 0, R0, C0, r0, 8 * (kk / 4 + 1) + 2 * q);
          edge_feats(x, 0, 1, R1, C1, r1, 8 * (kk / 4 + 1) + 2 * q);
        }
        if (kk > 0) {
          wg_wait<1>();
          slab_done(sm, ub + kk - 2, total, split, lane);
          slab_done(sm, ub + kk - 1, total, split, lane);
        }
      }
      wg_wait<0>();
      slab_done(sm, ub + 14, total, split, lane);
      slab_done(sm, ub + 15, total, split, lane);
      pin(h0);
      const float d0 = meta[e0], d1 = meta[e1];
      const float* p0 = sm.pa[wgi][at0];
      const float* p1 = sm.pa[wgi][at1];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 k = ld2(sm.k0d + c), u0 = ld2(p0 + c), u1 = ld2(p1 + c);
        h0[4 * j] += fmaf(d0, k.x, u0.x);
        h0[4 * j + 1] += fmaf(d0, k.y, u0.y);
        h0[4 * j + 2] += fmaf(d1, k.x, u1.x);
        h0[4 * j + 3] += fmaf(d1, k.y, u1.y);
      }
    }
    sync_group(bar);  // E and pa are read: the next tile's rows may land

    // ---- the next tile's rows by cp.async, its meta and later ids through
    // registers ---------------------------------------------------------------
    if (next < ntiles) stage_rows(g, sm, wgi, lg, next, b ^ 1, tw);
    float mv[MV];
#pragma unroll
    for (int i = 0; i < MV; ++i) mv[i] = next < ntiles ? meta_at(g, lg, next, tw + 128 * i) : 0.f;
    idv = tw < TE ? id_at(g, lg, next + step, ntiles, tw) : 0;

    // ---- 2. h1 = elu(h0) K1 + B1, out = elu(h1) K2 + B2: each k step's
    // elu and split while the last one's products run ------------------------
    float h1[64];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      Frag a[4];
      uint64_t bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * r + i;
        const float x[4] = {eluf(h0[4 * j]), eluf(h0[4 * j + 1]), eluf(h0[4 * j + 2]), eluf(h0[4 * j + 3])};
        a[i] = split_a(x);
        bw[i] = bdesc(h1_first(j) ? slab_wait(sm, ub + h1_slab(j)) : sm.ring[(ub + h1_slab(j)) % RING]) + h1_off(j) / 4;
      }
      pinf(a);
      wg_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * r + i;
        if (j < 4) mma3<S>(PART(h1, 0, 16), a[i], bw[i], j > 0);
        else if (j < 8) mma3<S>(PART(h1, 16, 16), a[i], bw[i], j > 4);
        else mma3<2 * S>(PART(h1, 32, 32), a[i], bw[i], j > 8);
      }
      wg_commit();
      if (r > 0) {
        wg_wait<1>();
#pragma unroll
        for (int j = 4 * r - 4; j < 4 * r; ++j)
          if (h1_last(j)) slab_done(sm, ub + h1_slab(j), total, split, lane);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 12; j < 16; ++j)
      if (h1_last(j)) slab_done(sm, ub + h1_slab(j), total, split, lane);
    pin(h1);

    float oq[4], op[8], ov[32];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      Frag a[4];
      uint64_t bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * r + i;
        const float2 bb = ld2(sm.b1 + 8 * j + 2 * q);
        const float x[4] = {eluf(h1[4 * j] + bb.x), eluf(h1[4 * j + 1] + bb.y), eluf(h1[4 * j + 2] + bb.x),
                            eluf(h1[4 * j + 3] + bb.y)};
        a[i] = split_a(x);
        bw[i] = bdesc(out_first(j) ? slab_wait(sm, ub + out_slab(j)) : sm.ring[(ub + out_slab(j)) % RING]) +
                out_off(j) / 4;
      }
      pinf(a);
      wg_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * r + i;
        if (j < 4) mma3<8>(oq, a[i], bw[i], j > 0);
        else if (j < 8) mma3<16>(op, a[i], bw[i], j > 4);
        else mma3<2 * S>(ov, a[i], bw[i], j > 8);
      }
      wg_commit();
      if (r > 0) {
        wg_wait<1>();
#pragma unroll
        for (int j = 4 * r - 4; j < 4 * r; ++j)
          if (out_last(j)) slab_done(sm, ub + out_slab(j), total, split, lane);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 12; j < 16; ++j)
      if (out_last(j)) slab_done(sm, ub + out_slab(j), total, split, lane);
    pin(oq);
    pin(op);
    pin(ov);

    // out -> shared memory: the logits' columns, V0 | V1
    {
      float(*logit)[TE] = sm.logit[wgi];
      float* val = sm.val[wgi];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * q + (i & 1);
        if (n < NK) logit[n][i < 2 ? e0 : e1] = oq[i] + sm.b2[n];
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 8 * jj + 2 * q + (i & 1);
          if (n < 3 * NK) logit[NK + n][i < 2 ? e0 : e1] = op[4 * jj + i] + sm.b2[NK + n];
        }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 8 * jj + 2 * q + (i & 1);
          val[(i < 2 ? e0 : e1) * LDV + n] = ov[4 * jj + i] + sm.b2[OV0 + n];
        }
    }
    sync_group(bar);

    // ---- 3. softmaxes: one thread per (edge, head) -------------------------
    {
      const int hh = tw / TE, e = tw % TE, a = e >> lg;
      const float(*logit)[TE] = sm.logit[wgi];
      float l[4];
      {
        const float* nqa = meta + 4 * TE + a * NQ;
        float v = 0.f;
        for (int k = 0; k < NK; ++k) v += nqa[hh * NK + k] * logit[k][e];
        l[0] = v * rsdk;
        for (int c = 0; c < 3; ++c) {
          v = 0.f;
          for (int k = 0; k < NK; ++k) v += nqa[NH * NK + hh * NK + k] * logit[NK + c * NK + k][e];
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
      float(*red)[8] = sm.red[wgi];
      if (nn > 32) {
        if (lane == 0) red[wq][0] = mq, red[wq][1] = mp;
        sync_group(bar);
        mq = fmaxf(mq, red[wq ^ 1][0]);
        mp = fmaxf(mp, red[wq ^ 1][1]);
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
        if (lane == 0) red[wq][2] = sq, red[wq][3] = sp, red[wq][4] = se2;
        sync_group(bar);
        sq += red[wq ^ 1][2];
        sp += red[wq ^ 1][3];
        se2 += red[wq ^ 1][4];
      }
      float* w = sm.w[wgi][e][hh];
      const float iq = 1.f / sq, ip = 1.f / sp;
      w[0] = ex[0] * iq;
      for (int c = 1; c < 4; ++c) w[c] = ex[c] * ip;
      if ((e & (nn - 1)) == 0) sm.s2[wgi][a][hh] = se2 * ip;
    }
    sync_group(bar);

    // ---- 4. value sums: 4 columns s of both heads an item, 2 items a thread --
    {
      // item k of an atom: k < 8 takes Zq[., s], s = 4k..4k+3; k >= 8 takes
      // Zp[x, ., s], x = (k - 8) / 8. SL = nn / 8 neighbouring lanes share an
      // item, slice sl summing edges sl, sl + SL, ... (8 of them): A * 32 * SL
      // = 4 TE items and slices. p_m and p_n come from L2: the rows buffer
      // holds the next tile's by now.
      const int lsl = lg - 3, SL = 1 << lsl;
      const float* val = sm.val[wgi];
      const float(*wts)[NH][4] = sm.w[wgi];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tt = tw + 128 * u, item = tt >> lsl, sl = tt & (SL - 1);
        const int a = item >> 5, k = item & 31, s = 4 * (k & 7), x = (k >> 3) - 1;
        float4 z0 = make_float4(0.f, 0.f, 0.f, 0.f), z1 = z0;
        if (x < 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = (a << lg) + sl + i * SL;
            const float w0 = wts[e][0][0], w1 = wts[e][1][0];
            const float4 v = ld4(val + e * LDV + s);
            z0 = make_float4(fmaf(w0, v.x, z0.x), fmaf(w0, v.y, z0.y), fmaf(w0, v.z, z0.z), fmaf(w0, v.w, z0.w));
            z1 = make_float4(fmaf(w1, v.x, z1.x), fmaf(w1, v.y, z1.y), fmaf(w1, v.z, z1.z), fmaf(w1, v.w, z1.w));
          }
        } else {
          float4 p[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = (a << lg) + sl + i * SL;
            p[i] = __ldg(reinterpret_cast<const float4*>(g.qp + (size_t)ids[e] * H + S + x * S + s));
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = (a << lg) + sl + i * SL;
            const float4 w0 = ld4(wts[e][0]), w1 = ld4(wts[e][1]);
            const float rx = meta[TE + 3 * e + x], u0 = w0.y * rx, u1 = w1.y * rx;
            const float4 v = ld4(val + e * LDV + S + s);
            z0 = make_float4(fmaf(w0.w, p[i].x, fmaf(u0, v.x, z0.x)), fmaf(w0.w, p[i].y, fmaf(u0, v.y, z0.y)),
                             fmaf(w0.w, p[i].z, fmaf(u0, v.z, z0.z)), fmaf(w0.w, p[i].w, fmaf(u0, v.w, z0.w)));
            z1 = make_float4(fmaf(w1.w, p[i].x, fmaf(u1, v.x, z1.x)), fmaf(w1.w, p[i].y, fmaf(u1, v.y, z1.y)),
                             fmaf(w1.w, p[i].z, fmaf(u1, v.z, z1.z)), fmaf(w1.w, p[i].w, fmaf(u1, v.w, z1.w)));
          }
        }
        for (int m = 1; m < SL; m <<= 1) {
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
            const float4 p = __ldg(reinterpret_cast<const float4*>(g.qp + (size_t)(g.row0 + atom) * H + S + x * S + s));
            const float s0 = sm.s2[wgi][a][0], s1 = sm.s2[wgi][a][1];
            float* out = g.zp + (size_t)atom * 3 * NH * S + x * NH * S + s;
            st4(out, make_float4(fmaf(s0, p.x, z0.x), fmaf(s0, p.y, z0.y), fmaf(s0, p.z, z0.z), fmaf(s0, p.w, z0.w)));
            st4(out + S, make_float4(fmaf(s1, p.x, z1.x), fmaf(s1, p.y, z1.y), fmaf(s1, p.z, z1.z), fmaf(s1, p.w, z1.w)));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MV; ++i)
      if (tw + 128 * i < META) sm.meta[wgi][b ^ 1][tw + 128 * i] = mv[i];
  }
}

}  // namespace wg

// pa[n] = [q_n, |p_n|] K0[1:2S+1] + B0 for every atom, fp32: the per-atom
// part of the first edge-MLP layer, 2 * 64 * 128 FLOP per atom. Only an
// atom's own row enters it (the tile kernel reads pa of its centre atoms
// alone), so it covers the n_atoms own rows, row0 onwards, and not the
// rest of a larger table. A block of 128 threads takes 32 atoms; thread c
// owns column c.
constexpr int AT = 32;

template <typename T>
__global__ void __launch_bounds__(H) atom_term_kernel(const Args<T> g, float* __restrict__ pa) {
  if constexpr (std::is_same<T, float>::value) {
    // fp32's grid has wg::NSLAB more blocks, which split the weights for
    // the tile kernel into the scratch after pa, a slab each
    const int atom_blocks = (g.n_atoms + AT - 1) / AT;
    if ((int)blockIdx.x >= atom_blocks) {
      wg::split_slab(g, blockIdx.x - atom_blocks, pa + (size_t)g.n_atoms * H);
      return;
    }
  }
  __shared__ __align__(16) float xn[2 * S][AT];  // [s][atom]: 16-byte reads of 4 atoms
  const int c = threadIdx.x, a0 = blockIdx.x * AT;
  for (int i = c; i < AT * 2 * S; i += H) {
    const int a = i % AT, s = i / AT;
    float v = 0.f;
    if (a0 + a < g.n_atoms) {
      const T* row = g.qp + (size_t)(g.row0 + a0 + a) * H;
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

// Blocks of `kern` (threads, smem bytes) that fit the current card at once,
// set up in cap[device] on the first launch there; or minus a CUDA error.
template <typename K>
int blocks_at_once(K kern, int threads, int smem, int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

// bf16
template <typename T>
int launch(Args<T> args, float* pa, cudaStream_t stream) {
  constexpr int TE = Tile<T>::TE;
  auto kern = edge_attention_kernel<T>;
  const int smem = (int)sizeof(Smem<T>);
  static int grid_cap[64] = {};
  const int cap = blocks_at_once(kern, 4 * TE, smem, grid_cap);
  if (cap < 0) return -cap;
  atom_term_kernel<T><<<(args.n_atoms + AT - 1) / AT, H, 0, stream>>>(args, pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  args.pa = pa;
  const int A = TE / args.nn, ntiles = (args.n_atoms + A - 1) / A;
  kern<<<ntiles < cap ? ntiles : cap, 4 * TE, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// fp32: pa is followed by the split weights (wg::SPLIT_FLOATS)
int launch(Args<float> args, float* pa, cudaStream_t stream) {
  auto kern = wg::edge_attention_kernel;
  const int smem = (int)sizeof(wg::Smem);
  static int grid_cap[64] = {};
  const int cap = blocks_at_once(kern, wg::THREADS, smem, grid_cap);
  if (cap < 0) return -cap;
  atom_term_kernel<float><<<(args.n_atoms + AT - 1) / AT + wg::NSLAB, H, 0, stream>>>(args, pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  args.pa = pa;
  const int A = wg::TE / args.nn, ntiles = (args.n_atoms + A - 1) / A, npairs = (ntiles + 1) / 2;
  kern<<<npairs < cap ? npairs : cap, wg::THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_as(const void* qp, const void* ids, const void* d, const void* r, const void* nq,
              const void* K0, const void* B0, const void* K1, const void* B1, const void* K2,
              const void* B2, void* zq, void* zp, void* pa, int n_atoms, int nn, int row0,
              cudaStream_t stream) {
  const Args<T> args{static_cast<const T*>(qp), static_cast<const int*>(ids),
                     static_cast<const T*>(d),  static_cast<const T*>(r),
                     static_cast<const T*>(nq), static_cast<const T*>(K0),
                     static_cast<const T*>(B0), static_cast<const T*>(K1),
                     static_cast<const T*>(B1), static_cast<const T*>(K2),
                     static_cast<const T*>(B2), static_cast<T*>(zq),
                     static_cast<T*>(zp),       nullptr,
                     n_atoms,                   nn,
                     row0};
  return launch(args, static_cast<float*>(pa), stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every floating input and both outputs).
// qp is a table of n_table >= row0 + n_atoms rows; the n_atoms atoms are its
// rows row0 .. row0 + n_atoms, and ids, d, r, nq and the outputs have
// n_atoms rows; an id may name any table row (a shard of one structure
// reads its neighbours from the whole structure's table). nn must be 8, 16,
// 32 or 64 (it divides the edge tile). pa is fp32 scratch of n_atoms x 128
// floats and, in float32, 55,296 more (wg::SPLIT_FLOATS: the weights split
// into TF32 hi and lo).
// qp and pa must be 16-byte aligned (their rows are copied 16 bytes at a
// time).
extern "C" int edge_attention(int dtype, const void* qp, const void* ids, const void* d,
                              const void* r, const void* nq, const void* K0, const void* B0,
                              const void* K1, const void* B1, const void* K2, const void* B2,
                              void* zq, void* zp, void* pa, int n_atoms, int nn, int row0,
                              int n_table, void* stream) {
  if (n_atoms <= 0) return 0;
  if (nn != 8 && nn != 16 && nn != 32 && nn != 64) return (int)cudaErrorInvalidValue;
  if (row0 < 0 || n_table < row0 + n_atoms) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qp) % 16 != 0 || reinterpret_cast<uintptr_t>(pa) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_as<float>(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, zq, zp, pa, n_atoms, nn, row0,
                            s);
  if (dtype == 1)
    return launch_as<__nv_bfloat16>(qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, zq, zp, pa, n_atoms,
                                    nn, row0, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
