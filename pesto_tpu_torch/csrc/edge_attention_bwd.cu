// Backward of the fused edge attention of one geometric state-update layer
// (sm_90a).
//
// Replaces the plain recompute in EdgeAttentionFunction.backward
// (pesto_tpu_torch/ops/edge_attention.py), which reran the layer op by op on
// the card and differentiated it with autograd. The TPU kernel it pairs with,
// pesto_tpu/ops/geometric_pallas.py:fused_edge_attention (line 257), is
// inference-only (pesto_tpu/models/config.py:77-80): the JAX package trains
// through jax.value_and_grad (pesto_tpu/train/step.py:47) of the XLA layer
// StateUpdate._fused (pesto_tpu/models/pesto.py:202-337), with per-layer
// remat. This kernel computes that VJP. Given the forward's inputs and the
// gradients of Zq [N, Nh*S] and Zp [N, 3*Nh*S] it returns the gradients of
// the table qp (every row, the atoms' own and every neighbour), of d, r and
// nq (where asked), and of K0, B0, K1, B1, K2, B2 (K1 and K2 on their
// diagonal blocks only, zero elsewhere: _pack's block_diag passes only those
// to the parameters). The function, step by step in this order, is
// edge_attention_backward_plain; per edge (atom n, slot j, neighbour m):
//
//   forward, rebuilt: E, h0 = elu(pre0), h1 = elu(pre1), out, the scalar
//     softmax Mq over the nn edges and the vector softmax Mp over 3 nn;
//   the value sums: dV0 = Mq^T dZq, dV1 = (Mp1 r)^T dZp, and the weights'
//     gradients dMq, dMp1, dMp2 (the same for every j: Z2 holds sum_j Mp2),
//     dMp3; dr from Z1, dp_m from Z3, dp_n from Z2;
//   the softmaxes: dl = M (dM - sum M dM) / sqrt(Nk) -> dout[0:12], dnq;
//   the MLP: dh1 = dout K2^T, dpre1 = dh1 elu'(pre1), dh0 = dpre1 K1^T,
//     dpre0 = dh0 elu'(pre0), dE = dpre0 K0e^T, and dK2 = h1^T dout,
//     dK1 = h0^T dpre1, dK0e = E^T dpre0, the biases, dK0[0] = d^T dpre0,
//     dd = dpre0 K0[0], and per atom dpa = sum_j dpre0;
//   the edge features: dq_m, d|p_m| (zero where safe_norm's floor holds:
//     clamp's gradient is 0 below 1e-36, which p = 0 at layer 0 meets),
//     <p_n, r> and <p_m, r> -> the neighbour row m, the own row n and dr.
//   per atom: dK0[1:65] = X_n^T dpa, dB0 = sum dpa, dX_n = dpa K0[1:65]^T
//     -> the own row's dq_n and d|p_n|.
//
// Bound on the H100: the nine edge-MLP products (forward, transposed and
// against the inputs), 3 x 54,016 = 162,048 FLOP per edge with the
// block-diagonal structure, on the tensor cores: bf16 operands at 989
// TFLOP/s; fp32 as three TF32 products (3xTF32) at 495 TFLOP/s. Bytes are
// few: the per-atom inputs, the neighbour rows (from L2) and one atomic add
// of 512 B per edge into the table's gradient.
//
// Design (edge_bwd_probe.py times each phase of the tile loop):
//   - a per-atom pre-pass computes pa = [q_n, |p_n|] K0[1:65] + B0 (fp32);
//   - one persistent block of 16 warps per SM walks tiles of TE = 64 edges
//     (64 / nn whole atoms). A tile whose atoms' gradient rows are all zero is
//     skipped: padding rows reach no loss, and every padding row gathers its
//     structure's sink row in all its slots, so their atomic adds would
//     serialise on that row. With finite inputs every term of such an atom is
//     an exact zero, so the skip changes nothing.
//   - every [TE, 128] activation lives in shared memory in the product's
//     type (bf16 values in bf16, fp32 in fp32), its rows' 16-byte chunks
//     XOR-swizzled by the row (ti), so that ldmatrix's 8 rows at one column
//     and fp32's transposed reads of 4 rows by 8 columns each hit distinct
//     banks: E, h0, h1, then in their places dE, dpre0, dpre1. out and dout
//     take E's buffer, and E is rebuilt from the rows before its product
//     with dpre0. Nothing [N, nn, *] reaches device memory.
//   - the products run on the tensor cores, every fragment from shared
//     memory by ldmatrix (.trans for the transposed operands of the weight
//     gradients, h^T dh and E^T dpre0, and for a weight read as K, not K^T)
//     in bf16, on mma.m16n8k16. fp32 runs 3xTF32 on mma.m16n8k8: its A
//     fragments by ldmatrix, its transposed operands by 32-bit reads
//     (ldmatrix.trans moves 16-bit elements), each value split into TF32 hi
//     and lo once a fragment. tf32 wgmma reads only K-major operands from
//     shared memory, so fp32 stays on mma.sync; so does bf16, for now.
//   - the weights: bf16 keeps K0e and the diagonal blocks of K1 and K2 in
//     shared memory (60 KB, rows padded by 16 bytes), copied once per block,
//     one copy serving K (ldmatrix.trans) and K^T (ldmatrix). fp32's copy
//     would take 120 KB, which its fp32 tiles leave no room for: it reads a
//     copy laid out in fragment order (edge_bwd_pack, once per launch), one
//     coalesced 8-byte load a fragment, from L1 or L2.
//   - each warp takes 16 edges and 32 columns of a product over edges; the
//     four warps of one group of 16 edges chain E, h0, h1 and out behind a
//     barrier of their own (bar.sync 1 + group, 128).
//   - the weight gradients: dK1 and dK2 accumulate in shared memory (12
//     jobs of 16 rows each, in fragment order, loaded, added to and stored
//     once a tile, each job before its warp's transposed product so that
//     the two are never live together), dK0e in registers (32 a thread, 16
//     rows by 64 columns a warp): at most 128 registers a thread, 16 warps.
//     They are written once per block as fp32 partials, and a second kernel
//     sums the partials over the blocks in a fixed order, so they are the
//     same from run to run. The column sums (dB1, dB2, dK0[0], dpa, dd) come
//     from the products' registers by butterfly shuffles (lanes_scatter) and
//     are summed over the warps in a fixed order too.
//   - the copies overlap the work: the next tile's per-atom and per-edge
//     inputs by bulk copies (TMA) that one warp issues at the top of a tile,
//     completing on an mbarrier; its neighbour rows by 16-byte cp.async from
//     many threads, each arriving on an mbarrier once its copies land: in
//     bf16, into a third row buffer, by the 12 warps that wait out the
//     softmax; in fp32, into the buffer that held dpre1, in the dpre0 step.
//     Only the bf16 tiles leave room for the third buffer.
//   - the softmaxes take one thread per (edge, head) on warps 0-3, whose
//     nn = 64 reductions pair two warps behind a named barrier (id 5); the
//     dot products they need come from the out phase's registers, and the
//     sums of dnq's terms from the dout phase's threads.
//   - the table's gradient is summed by red.global.add of four fp32 columns
//     an instruction into an fp32 table (the output itself in fp32; scratch
//     cast once to bf16 in bf16). Its order changes from run to run.
//   - the per-atom kernel sums dK0[1:65] and dB0 per block (fixed order) and
//     adds the own rows' dq_n and d|p_n| to the table.
// bf16: the values the kernel keeps in shared memory are rounded to bf16
// (E, h0, h1, out, dout, dpre1, dpre0, dE: the product operands, and h0,
// h1 where elu' reads them, and dE where the edge features read it);
// everything else, the column sums among it, is fp32.

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
constexpr int NG = NH * S + 3 * NH * S;    // an atom's gradient row: dZq | dZp, 256
constexpr int TE = 64;                     // edges per tile
constexpr int THREADS = 512;               // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAXA = TE / 8;               // atoms per tile at nn = 8
constexpr int AT = 32;                     // atoms per chunk of the per-atom kernels
// out and dout in a tile: the 12 logit columns at 0 .. 11, zeros at 12 .. 15,
// V0 | V1 (dV0 | dV1) at ODV .. ODV + 63, on a 16-byte boundary in bf16
constexpr int ODV = 16;
// bf16 weight blocks in shared memory: row strides, padded by 8 values so
// that the 8 rows an ldmatrix reads fall on 8 distinct bank groups
constexpr int LK0 = H + 8, LK1 = S + 8, LKV = 2 * S + 8, LK2 = 16 + 8;
// The shared-memory partials of dK1 (12 jobs of 16 rows by 32 columns) and
// dK2 (4 jobs of 16 rows by 16 columns on its q | p blocks, 8 of 16 by 32 on
// its v block), in fragment order: n tile n of lane l of a job at the job's
// base + (32 n + l) * 4.
constexpr int PK_K2 = 12 * 512, PK_K2V = PK_K2 + 4 * 256, PK_SIZE = PK_K2V + 8 * 512;
// per-warp column sums: dB2 [16][80]; dB1 [4][128]; dK0[0], dpa, dd [4 + 8][128]
// + [4][64]; and from DQ on, the softmax's dnq terms [NH * 6][TE]
constexpr int DQ = 10 * H, SUMS = DQ + TE * NH * 6;

// A block's partial weight gradients (fp32, dense indices of the weights;
// only the diagonal blocks of K1 and K2 are written and read).
constexpr int P_K0E = 0;                   // [H][H]: K0 rows 1 + 2S ..
constexpr int P_K1 = P_K0E + H * H;        // [H][H]
constexpr int P_K2 = P_K1 + H * H;         // [H][NOUT]
constexpr int P_K0D = P_K2 + H * NOUT;     // K0 row 0
constexpr int P_B1 = P_K0D + H;
constexpr int P_B2 = P_B1 + H;
constexpr int P_SIZE = (P_B2 + NOUT + 3) / 4 * 4;
// the per-atom kernel's: K0 rows 1 .. 2S, then B0
constexpr int AP_K0X = 0;
constexpr int AP_B0 = AP_K0X + 2 * S * H;
constexpr int AP_SIZE = AP_B0 + H;

template <typename T>
struct Smem {
  static constexpr bool BF = sizeof(T) == 2;
  // the neighbour rows ([e][H], unswizzled), and h1 then dpre1, in turns:
  // bf16 has room for a third buffer, into which the next tile's rows are
  // copied while this tile computes its softmax; fp32 copies them into the
  // buffer that held dpre1, once dh0 is done
  static constexpr int NB = BF ? 3 : 2;
  // the threads that copy the rows: bf16 the 12 warps that wait out the
  // softmax (threads 128 ..), fp32 all, in the dpre0 step
  static constexpr int COPIERS = BF ? THREADS - 128 : THREADS;
  alignas(16) T buf[NB][TE * H];
  alignas(16) T x0[TE * H];        // E, out then dout, E again, dE
  alignas(16) T x1[TE * H];        // h0, then dpre0
  alignas(16) T cen[2][MAXA * H];  // the atoms' own rows
  alignas(16) float pa[2][MAXA * H];  // per-atom first-layer term, B0 included
  alignas(16) T gz[2][MAXA * NG];  // dZq [h][s] | dZp [x][h][s]
  alignas(16) T nq[MAXA * NQ];
  alignas(16) T dist[2][TE];
  alignas(16) T rv[2][TE * 3];
  alignas(16) int ids[2][TE];
  alignas(16) T k0e[BF ? H * LK0 : 8];                    // bf16: K0e [k][n]
  alignas(16) T k1[BF ? 2 * S * LK1 + 2 * S * LKV : 8];   // K1's q [32][LK1], p [32][LK1], v [64][LKV]
  alignas(16) T k2[BF ? 2 * S * LK2 + 2 * S * LKV : 8];   // K2's q | p [64][LK2] (zero off the blocks), v [64][LKV]
  alignas(16) float pk[PK_SIZE];   // dK1, dK2
  alignas(16) float sums[SUMS];
  float k0d[H], b1[H], b2[NOUT];
  float dk0d[H], db1[H], db2[NOUT];  // the block's sums of K0[0]'s, B1's, B2's gradients
  float w[TE][NH][4];   // Mq, Mp1, Mp2, Mp3
  float dl[TE][NH][4];  // the logits' gradients, 1/sqrt(Nk) included
  float drz[TE][NH][3]; // dr's part from Z1, per head
  float dm[TE][NH][2];  // dMq, dMp3
  float dm2[MAXA][NH];  // dMp2 = dZp . p_n, per atom
  float tx[TE][NH][3];  // dZp_x . V1
  float s2[MAXA][NH];   // sum_j Mp2
  float red[4][16];     // the softmax warps' partials of the nn = 64 reductions
  int act[MAXA];        // the atom has a non-zero gradient row
  alignas(8) unsigned long long bar[2 + NB];  // the copies done: inputs into buffer b bar[b], rows into buf[b] bar[2 + b]
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
// elu as the forward kernel takes it, and its derivative from its value:
// 1 where x > 0 (elu(x) > 0), else exp(x) = elu(x) + 1
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }
__device__ __forceinline__ float elu_grad(float y) { return y > 0.f ? 1.f : y + 1.f; }
// |(x, y, z)| floored at 1e-18, as in the forward kernel
__device__ __forceinline__ float norm3(float x, float y, float z) {
  const float s = fmaxf(x * x + y * y + z * z, 1e-36f);
  return s * rsqrtf(s);
}

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
__device__ __forceinline__ void st2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}
// four fp32 columns added to device memory in one reduction (sm_90)
__device__ __forceinline__ void red4(float* p, float4 v) { atomicAdd(reinterpret_cast<float4*>(p), v); }

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
// the block's earlier shared-memory accesses ordered before this thread's bulk copies
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// an arrival on the mbarrier once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(su32(bar)) : "memory");
}

// The block's barrier, and the named barrier of the 4 warps of group id - 1
// (warps id - 1, id + 3, id + 7, id + 11) or, id 5, of the softmax warps 0-3.
__device__ __forceinline__ void sync_all() { __syncthreads(); }
__device__ __forceinline__ void sync_group(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// ---- the tile layout ----------------------------------------------------------
//
// Element (row e, column c) of a [TE][H] tile of T: the row's 16-byte chunks
// XOR-ed by swz(e), a bijection of e % 8 whose value for rows e .. e + 3 (e
// a multiple of 4) differs in bits 1-2. So the 8 rows that one ldmatrix
// reads at one logical chunk fall on 8 distinct bank groups, and fp32's
// 32-bit reads of rows e + q (q < 4) at columns n .. n + 7 (n a multiple
// of 8: two chunks) on 32 distinct banks.
__device__ __forceinline__ int swz(int e) { return ((e & 3) << 1) | ((e >> 2) & 1); }
template <typename T>
__device__ __forceinline__ int ti(int e, int c) {
  constexpr int V = 16 / (int)sizeof(T);
  return e * H + (((c / V) ^ swz(e)) * V) + (c % V);
}

// ---- tensor-core products -----------------------------------------------------
//
// A C-layout tile acc[n][4] holds, for lane (g = lane / 4, q = lane % 4),
// rows g and g + 8, columns 2q and 2q + 1 of the n-th 8-column group:
// acc[n][i] is row g + 8 (i / 2), column 8n + 2q + i % 2. Mm<T> loads the
// fragments of one k step (KS) of a product and runs it on two n tiles:
//   a_rows: A = rows e0 .. e0 + 15 of a tile, columns k0 ..;
//   a_cols: A = X^T, rows i0 .. i0 + 15 of it (columns of the tile X),
//     k = the tile's rows e0 ..;
//   b_tile: B = a tile [e][n], k = its rows e0 .., columns n0 .. n0 + 15;
//   b_kn / b_nk (bf16): B from a weight block stored [k][n] / [n][k].

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// x = hi + lo: hi is x truncated to TF32, lo = x - hi, which the tensor
// core reads truncated to TF32 too. Truncating hi (not rounding it, as
// csrc/edge_attention.cu does) takes one instruction less a value; |lo| <
// 2^-10 |x| (2^-11 rounded), so a product's error stays below 2^-20 |x| |y|,
// far under fp32's tolerance. Finite inputs only.
__device__ __forceinline__ void split_t(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
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

template <typename T> struct Mm;

// bf16: m16n8k16. The lanes of quarter j of the warp point ldmatrix at the
// 8 rows of its matrix j: A (rows, columns) 0: (0-7, 0-7), 1: (8-15, 0-7),
// 2: (0-7, 8-15), 3: (8-15, 8-15); B (k, n) 0: (0-7, 0-7), 1: (8-15, 0-7),
// 2: (0-7, 8-15), 3: (8-15, 8-15), i.e. n tile 0 then n tile 1.
template <> struct Mm<__nv_bfloat16> {
  using B16 = __nv_bfloat16;
  static constexpr int KS = 16;
  struct A { uint32_t r[4]; };
  struct B2 { uint32_t r[4]; };
  static __device__ __forceinline__ void a_rows(A& a, const B16* t, int e0, int k0, int lane) {
    const int j = lane >> 3;
    ldsm_x4(a.r, t + ti<B16>(e0 + (lane & 7) + 8 * (j & 1), k0 + 8 * (j >> 1)));
  }
  static __device__ __forceinline__ void a_cols(A& a, const B16* t, int i0, int e0, int lane) {
    const int j = lane >> 3;
    ldsm_x4_t(a.r, t + ti<B16>(e0 + (lane & 7) + 8 * (j >> 1), i0 + 8 * (j & 1)));
  }
  static __device__ __forceinline__ void b_tile(B2& b, const B16* t, int e0, int n0, int lane) {
    const int j = lane >> 3;
    ldsm_x4_t(b.r, t + ti<B16>(e0 + (lane & 7) + 8 * (j & 1), n0 + 8 * (j >> 1)));
  }
  static __device__ __forceinline__ void b_kn(B2& b, const B16* w, int ld, int k0, int n0, int lane) {
    const int j = lane >> 3;
    ldsm_x4_t(b.r, w + (k0 + (lane & 7) + 8 * (j & 1)) * ld + n0 + 8 * (j >> 1));
  }
  static __device__ __forceinline__ void b_nk(B2& b, const B16* w, int ld, int k0, int n0, int lane) {
    const int j = lane >> 3;
    ldsm_x4(b.r, w + (n0 + (lane & 7) + 8 * (j >> 1)) * ld + k0 + 8 * (j & 1));
  }
  static __device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4], const A& a, const B2& b) {
    mma_bf16(c0, a.r, b.r[0], b.r[1]);
    mma_bf16(c1, a.r, b.r[2], b.r[3]);
  }
};

// fp32: 3xTF32 on m16n8k8. A fragment (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4); B fragment (k = q, n = g), (k = q + 4, n = g). ldmatrix
// reads A as b16 pairs: a 16-byte row of its matrix is 4 fp32 values.
template <> struct Mm<float> {
  static constexpr int KS = 8;
  struct A { uint32_t h[4], l[4]; };
  struct B2 { uint32_t h[4], l[4]; };  // n tile 0: [0] k = q, [1] k = q + 4; n tile 1: [2], [3]
  static __device__ __forceinline__ void a_rows(A& a, const float* t, int e0, int k0, int lane) {
    const int j = lane >> 3;
    uint32_t r[4];
    ldsm_x4(r, t + ti<float>(e0 + (lane & 7) + 8 * (j & 1), k0 + 4 * (j >> 1)));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_t(__uint_as_float(r[i]), a.h[i], a.l[i]);
  }
  static __device__ __forceinline__ void a_cols(A& a, const float* t, int i0, int e0, int lane) {
    const int g = lane >> 2, q = lane & 3;
    split_t(t[ti<float>(e0 + q, i0 + g)], a.h[0], a.l[0]);
    split_t(t[ti<float>(e0 + q, i0 + g + 8)], a.h[1], a.l[1]);
    split_t(t[ti<float>(e0 + q + 4, i0 + g)], a.h[2], a.l[2]);
    split_t(t[ti<float>(e0 + q + 4, i0 + g + 8)], a.h[3], a.l[3]);
  }
  static __device__ __forceinline__ void b_tile(B2& b, const float* t, int e0, int n0, int lane) {
    const int g = lane >> 2, q = lane & 3;
    split_t(t[ti<float>(e0 + q, n0 + g)], b.h[0], b.l[0]);
    split_t(t[ti<float>(e0 + q + 4, n0 + g)], b.h[1], b.l[1]);
    split_t(t[ti<float>(e0 + q, n0 + 8 + g)], b.h[2], b.l[2]);
    split_t(t[ti<float>(e0 + q + 4, n0 + 8 + g)], b.h[3], b.l[3]);
  }
  // the fragments of slots slot and slot + 1 of the packed weights
  static __device__ __forceinline__ void b_pack(B2& b, const float2* wp, int slot, int lane) {
    const float2 u = wp[slot * 32 + lane], v = wp[(slot + 1) * 32 + lane];
    split_t(u.x, b.h[0], b.l[0]);
    split_t(u.y, b.h[1], b.l[1]);
    split_t(v.x, b.h[2], b.l[2]);
    split_t(v.y, b.h[3], b.l[3]);
  }
  static __device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4], const A& a, const B2& b) {
    mma_tf32(c0, a.l, b.h[0], b.h[1]);
    mma_tf32(c0, a.h, b.l[0], b.l[1]);
    mma_tf32(c0, a.h, b.h[0], b.h[1]);
    mma_tf32(c1, a.l, b.h[2], b.h[3]);
    mma_tf32(c1, a.h, b.l[2], b.l[3]);
    mma_tf32(c1, a.h, b.h[2], b.h[3]);
  }
};

// acc[NT][4] += A B over k < K: la(a, k0) loads the A fragment of k step
// k0, lb(b, k0, n) the B fragments of n tiles n and n + 1 (NT even). The k
// loop is unrolled by four, so that later steps' loads overlap a step's
// products (by two, fp32's products of a weight read from L2 took 4% longer
// on an H100).
template <typename T, int NT, int K, typename LA, typename LB>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const LA& la, const LB& lb) {
  static_assert(NT % 2 == 0 && K % Mm<T>::KS == 0, "n tiles in pairs, whole k steps");
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += Mm<T>::KS) {
    typename Mm<T>::A a;
    la(a, k0);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      typename Mm<T>::B2 b;
      lb(b, k0, n);
      Mm<T>::mma2(acc[n], acc[n + 1], a, b);
    }
  }
}

// ---- the fp32 weights in fragment order -------------------------------------
//
// fp32 reads each weight product's B from a copy laid out as the mma's B
// fragments (edge_bwd_pack, once per launch): slot (k step, n group) holds
// the 32 lanes' fragments one after the other (the two values, 256 B), so a
// warp reads a fragment as one coalesced run. (Stored split into TF32 hi and
// lo, the copy doubles, and the products waited on L2 longer than the split
// takes: 3.6 ms against 3.2 at N=8192, nn=64, edge_ab.py on an H100.) The segments, one per
// product and diagonal block, with their n groups (8 columns each) and k
// steps; K2's q and p blocks are one 64 x 16 block (q | p, zero off them):
//   0 h0 = E K0e | 1-3 h1 = h0 K1 (q, p, v) | 4-5 out = h1 K2 (q | p, v)
//   6-7 dh1 = dout K2^T | 8-10 dh0 = dpre1 K1^T | 11 dE = dpre0 K0e^T
__host__ __device__ constexpr int seg_nt(int s) {
  return s == 0 || s == 11 ? 16 : (s == 1 || s == 2 || s == 8 || s == 9) ? 4 : s == 4 ? 2 : 8;
}
__host__ __device__ constexpr int seg_ks(int s) {
  return s == 0 || s == 11 ? 16 : (s == 1 || s == 2 || s == 8 || s == 9) ? 4 : s == 6 ? 2 : 8;
}
__host__ __device__ constexpr int seg_off(int s) { return s == 0 ? 0 : seg_off(s - 1) + seg_nt(s - 1) * seg_ks(s - 1); }
constexpr int SEGS = 12, SLOTS = seg_off(SEGS);
constexpr int WPACK_FLOATS = SLOTS * 32 * 2;

// K2's q | p block at (hidden row k < 64, column n < 16): zero off the blocks
template <typename T>
__device__ __forceinline__ float k2_qp(const T* K2, int k, int n) {
  return (k < S && n < NK) || (k >= S && n >= NK && n < OV0) ? tof(K2[k * NOUT + n]) : 0.f;
}

// B of segment `seg` at (k, n) of its product
template <typename T>
__device__ __forceinline__ float seg_value(const T* K0, const T* K1, const T* K2, int seg, int k, int n) {
  switch (seg) {
    case 0: return tof(K0[(1 + 2 * S + k) * H + n]);
    case 1: return tof(K1[k * H + n]);
    case 2: return tof(K1[(S + k) * H + S + n]);
    case 3: return tof(K1[(2 * S + k) * H + 2 * S + n]);
    case 4: return k2_qp(K2, k, n);
    case 5: return tof(K2[(2 * S + k) * NOUT + OV0 + n]);
    case 6: return k2_qp(K2, n, k);
    case 7: return tof(K2[(2 * S + n) * NOUT + OV0 + k]);
    case 8: return tof(K1[n * H + k]);
    case 9: return tof(K1[(S + n) * H + S + k]);
    case 10: return tof(K1[(2 * S + n) * H + 2 * S + k]);
    default: return tof(K0[(1 + 2 * S + n) * H + k]);
  }
}

// The B of a weight product: bf16 from the block's copy in shared memory (w,
// row stride ld; kn: stored [k][n], else [n][k]); fp32 from the packed
// fragments (segment at slot off with ntall groups a k step). n0: the first
// column.
template <typename T>
struct WB {
  const T* w;
  int ld;
  bool kn;
  const float2* wp;
  int off, ntall, n0, lane;
  __device__ __forceinline__ void operator()(typename Mm<T>::B2& b, int k0, int n) const {
    if constexpr (sizeof(T) == 2) {
      if (kn) Mm<T>::b_kn(b, w, ld, k0, n0 + 8 * n, lane);
      else Mm<T>::b_nk(b, w, ld, k0, n0 + 8 * n, lane);
    } else {
      Mm<T>::b_pack(b, wp, off + (k0 / 8) * ntall + n0 / 8 + n, lane);
    }
  }
};

// block `off` of a bf16 weight copy in shared memory (fp32 keeps none: its
// placeholder array)
template <typename T>
__device__ __forceinline__ const T* wblk(const T* w, int off) {
  return sizeof(T) == 2 ? w + off : w;
}

template <typename T>
struct Args {
  const T* qp;
  const int* ids;
  const T *dist, *rvec, *nq, *K0, *B0, *K1, *B1, *K2, *B2, *gzq, *gzp;
  T *dd, *dr, *dnq;  // written where flags (1, 2, 4) ask
  float* dqp;        // the table's gradient, fp32
  float *pa, *dpa;   // [n_atoms, H] per-atom first-layer term and its gradient
  float *part, *apart;
  const void* wpack;  // fp32: the weights in fragment order (edge_bwd_pack)
  int n_atoms, nn, row0, flags;
};

// Sums (maxima) of v over the nn edges of an atom, for the softmax warps'
// layout of one thread per (edge, head): nn <= 32 edges are neighbouring
// lanes; nn = 64 pairs warps w and w ^ 1 through sm.red[.][slot ..]. Every
// thread of warps 0-3 calls it.
template <bool MAX, int NV, typename T>
__device__ __forceinline__ void seg_reduce(float (&v)[NV], int nn, Smem<T>& sm, int warp, int lane, int slot) {
  const int width = nn < 32 ? nn : 32;
  for (int o = 1; o < width; o <<= 1)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = MAX ? fmaxf(v[i], u) : v[i] + u;
    }
  if (nn > 32) {
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < NV; ++i) sm.red[warp][slot + i] = v[i];
    sync_group(5);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float u = sm.red[warp ^ 1][slot + i];
      v[i] = MAX ? fmaxf(v[i], u) : v[i] + u;
    }
  }
}

// v summed over the lanes whose bits `from` .. `to` differ (xor shuffles)
__device__ __forceinline__ float lanes_sum(float v, int from, int to) {
  for (int o = from; o <= to; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[0 .. N) summed over the 2^R lanes whose lane bits m, 2m, .. 2^(R-1) m
// differ, the sums spread over those lanes (N - N / 2^R shuffles, not R N):
// on return v[j], j < N / 2^R, holds the sum of index
// (N / 2^R) ((lane / m) % 2^R) + j.
template <int N, int R>
__device__ __forceinline__ void lanes_scatter(float (&v)[N], int lane, int m) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int mr = m << (R - 1 - r), half = N >> (r + 1);
    const bool up = lane & mr;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half], keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mr);
    }
  }
}

// The copies of a tile's inputs, issued by one warp (PRODUCER) so that no
// other warp spends a cycle on them: the per-atom and per-edge inputs of
// tile `tile` into buffer b, a bulk copy each (the gradient rows one an
// atom), completing on bar[b]; zeros past the last atom. (nq, whose rows
// are not 16-byte multiples in bf16, is loaded by the threads that store it.)
constexpr int PRODUCER = WARPS - 1;

template <typename T>
__device__ __forceinline__ void produce_inputs(Smem<T>& sm, const Args<T>& g, int b, int tile, int A, int lg, int lane) {
  const int nn = 1 << lg, a0 = tile * A, na = min(A, g.n_atoms - a0), ne = na * nn;
  for (int i = na * NG + lane; i < A * NG; i += 32) sm.gz[b][i] = fromf<T>(0.f);
  for (int i = na * H + lane; i < A * H; i += 32) sm.cen[b][i] = fromf<T>(0.f), sm.pa[b][i] = 0.f;
  for (int i = ne + lane; i < TE; i += 32) sm.ids[b][i] = 0, sm.dist[b][i] = fromf<T>(0.f);
  for (int i = 3 * ne + lane; i < 3 * TE; i += 32) sm.rv[b][i] = fromf<T>(0.f);
  fence_async();
  __syncwarp();
  if (lane == 0)
    mbar_expect(&sm.bar[b], (uint32_t)(na * (NG + H) * sizeof(T) + na * H * 4 + ne * (4 + 4 * sizeof(T))));
  __syncwarp();
  if (lane < na)
    bulk_copy(sm.gz[b] + lane * NG, g.gzq + (size_t)(a0 + lane) * NH * S, NH * S * sizeof(T), &sm.bar[b]);
  else if (lane >= 8 && lane < 8 + na)
    bulk_copy(sm.gz[b] + (lane - 8) * NG + NH * S, g.gzp + (size_t)(a0 + lane - 8) * 3 * NH * S,
              3 * NH * S * sizeof(T), &sm.bar[b]);
  else if (lane == 16)
    bulk_copy(sm.cen[b], g.qp + (size_t)(g.row0 + a0) * H, na * H * sizeof(T), &sm.bar[b]);
  else if (lane == 17)
    bulk_copy(sm.pa[b], g.pa + (size_t)a0 * H, na * H * 4, &sm.bar[b]);
  else if (lane == 18)
    bulk_copy(sm.ids[b], g.ids + (size_t)a0 * nn, ne * 4, &sm.bar[b]);
  else if (lane == 19)
    bulk_copy(sm.dist[b], g.dist + (size_t)a0 * nn, ne * sizeof(T), &sm.bar[b]);
  else if (lane == 20)
    bulk_copy(sm.rv[b], g.rvec + (size_t)a0 * nn * 3, 3 * ne * sizeof(T), &sm.bar[b]);
}

// The neighbour rows of the tile whose inputs are in buffer b (once they
// have landed: bar[b] at `parity`) into row buffer rb, 16 bytes a cp.async,
// by copier i of Smem<T>::COPIERS threads, each arriving on bar[2 + rb] once
// its copies have landed. (A bulk copy a row, issued by one warp, kept that
// warp ~90 cycles a row on an H100: the block waited for it.)
template <typename T>
__device__ __forceinline__ void copy_rows(Smem<T>& sm, const Args<T>& g, int b, uint32_t parity, int rb, int i) {
  constexpr int V = 16 / (int)sizeof(T), CH = H / V;
  mbar_wait(&sm.bar[b], parity);
  for (int j = i; j < TE * CH; j += Smem<T>::COPIERS) {
    const int e = j / CH, c = (j % CH) * V;
    cp_async16(sm.buf[rb] + e * H + c, g.qp + (size_t)sm.ids[b][e] * H + c);
  }
  cp_async_arrive(&sm.bar[2 + rb]);
}

// E = [q_m, |p_m|, <p_n, r>, <p_m, r>] of edge e, columns s .. s + 3 of each
// region, into x0.
template <typename T>
__device__ __forceinline__ void edge_E(Smem<T>& sm, const T* rows, int b, int e, int s, int lg) {
  const T* C = sm.cen[b] + (e >> lg) * H;
  const float rx = tof(sm.rv[b][3 * e]), ry = tof(sm.rv[b][3 * e + 1]), rz = tof(sm.rv[b][3 * e + 2]);
  const T* R = rows + e * H + s;
  const float4 qm = ld4(R), mx = ld4(R + S), my = ld4(R + 2 * S), mz = ld4(R + 3 * S);
  const float4 nx = ld4(C + S + s), ny = ld4(C + 2 * S + s), nz = ld4(C + 3 * S + s);
  st4(sm.x0 + ti<T>(e, s), qm);
  st4(sm.x0 + ti<T>(e, S + s),
      make_float4(norm3(mx.x, my.x, mz.x), norm3(mx.y, my.y, mz.y), norm3(mx.z, my.z, mz.z), norm3(mx.w, my.w, mz.w)));
  st4(sm.x0 + ti<T>(e, 2 * S + s),
      make_float4(nx.x * rx + ny.x * ry + nz.x * rz, nx.y * rx + ny.y * ry + nz.y * rz,
                  nx.z * rx + ny.z * ry + nz.z * rz, nx.w * rx + ny.w * ry + nz.w * rz));
  st4(sm.x0 + ti<T>(e, 3 * S + s),
      make_float4(mx.x * rx + my.x * ry + mz.x * rz, mx.y * rx + my.y * ry + mz.y * rz,
                  mx.z * rx + my.z * ry + mz.z * rz, mx.w * rx + my.w * ry + mz.w * rz));
}

// A job's fragments of the shared-memory partials (sm.pk): n tile n of
// lane l at p + (32 n + l) * 4.
template <int NT>
__device__ __forceinline__ void load_frag(float (&acc)[NT][4], const float* p, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) *reinterpret_cast<float4*>(acc[n]) = *reinterpret_cast<const float4*>(p + (32 * n + lane) * 4);
}
template <int NT>
__device__ __forceinline__ void store_frag(const float (&acc)[NT][4], float* p, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) *reinterpret_cast<float4*>(p + (32 * n + lane) * 4) = *reinterpret_cast<const float4*>(acc[n]);
}

// The dense index in a block's partials of element i of the shared-memory
// partials of dK1 and dK2 (sm.pk), or -1 off K2's diagonal blocks.
__host__ __device__ __forceinline__ int pk_dense(int i) {
  int job, r, kind;  // kind 0: dK1, 1: dK2's q | p, 2: dK2's v
  if (i < PK_K2) job = i / 512, r = i % 512, kind = 0;
  else if (i < PK_K2V) job = (i - PK_K2) / 256, r = (i - PK_K2) % 256, kind = 1;
  else job = (i - PK_K2V) / 512, r = (i - PK_K2V) % 512, kind = 2;
  const int n = r / 128, ln = (r / 4) % 32, k = r % 4;
  const int row = (ln >> 2) + 8 * (k >> 1), col = 8 * n + 2 * (ln & 3) + (k & 1);
  if (kind == 0) {
    const int i0 = job < 4 ? 16 * job : 2 * S + 16 * ((job - 4) & 3);
    const int c0 = job < 2 ? 0 : job < 4 ? S : 2 * S + 32 * ((job - 4) >> 2);
    return P_K1 + (i0 + row) * H + c0 + col;
  }
  if (kind == 1) {
    const int k2r = 16 * job + row;
    return (k2r < S && col < NK) || (k2r >= S && col >= NK && col < OV0) ? P_K2 + k2r * NOUT + col : -1;
  }
  return P_K2 + (2 * S + 16 * (job & 3) + row) * NOUT + OV0 + 32 * (job >> 2) + col;
}

// The weights in fragment order (fp32), one thread a lane of a slot: the
// two values of the tf32 B fragment (k = q and q + 4) at n = 8 (the slot's
// n group) + lane / 4.
template <typename T>
__global__ void edge_bwd_pack(const Args<T> g, float2* wpack) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= SLOTS * 32) return;
  const int slot = i / 32, lane = i % 32, q = lane & 3;
  int seg = 0;
  while (seg + 1 < SEGS && slot >= seg_off(seg + 1)) ++seg;
  const int r = slot - seg_off(seg), k0 = 8 * (r / seg_nt(seg)), n = 8 * (r % seg_nt(seg)) + (lane >> 2);
  wpack[i] = make_float2(seg_value(g.K0, g.K1, g.K2, seg, k0 + q, n), seg_value(g.K0, g.K1, g.K2, seg, k0 + q + 4, n));
}

// pa[n] = [q_n, |p_n|] K0[1:2S+1] + B0 for every atom, fp32, as the forward
// kernel's atom_term_kernel computes it: a block of 128 threads takes 32
// atoms, thread c owns column c.
template <typename T>
__global__ void __launch_bounds__(H) edge_bwd_atom_term(const Args<T> g) {
  __shared__ __align__(16) float xn[2 * S][AT];
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
  for (int s = 0; s < 2 * S; ++s) k[s] = tof(g.K0[(1 + s) * H + c]);
#pragma unroll
  for (int s = 0; s < 2 * S; ++s)
#pragma unroll
    for (int a = 0; a < AT; ++a) acc[a] = fmaf(xn[s][a], k[s], acc[a]);
  const float b = tof(g.B0[c]);
#pragma unroll
  for (int a = 0; a < AT; ++a)
    if (a0 + a < g.n_atoms) g.pa[(size_t)(a0 + a) * H + c] = acc[a] + b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) edge_bwd_tile(const Args<T> g) {
  using M = Mm<T>;
  using FA = typename M::A;
  using FB = typename M::B2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gq = lane >> 2, q = lane & 3;
  const int nn = g.nn, lg = __ffs(nn) - 1, A = TE >> lg;
  const int ntiles = (g.n_atoms + A - 1) / A;
  const float rsdk = 1.f / sqrtf((float)NK);
  // products over the tile's edges: this warp's 16 edges (its group mt)
  // and 32 columns (quarter qn)
  const int mt = warp & 3, qn = warp >> 2, e0 = 16 * mt;
  // its job in dK2 and in dK1 (12 each; warps 0-7, whose share of dh1 and
  // dh0 is the smaller, take the 8 of the v blocks)
  const int job = warp < 8 ? 4 + warp : warp < 12 ? warp - 8 : -1;
  const float2* wp = static_cast<const float2*>(g.wpack);
  float gk0[8][4] = {};  // dK0e rows 16 (warp % 8) .., columns 64 (warp / 8) ..

  // ---- once per block: the weights (bf16), biases, zeroed sums, the first tile's inputs
  if constexpr (sizeof(T) == 2) {
    for (int i = t; i < H * H / 8; i += THREADS) {
      const int k = i >> 4, c = (i & 15) * 8;
      cp_async16(sm.k0e + k * LK0 + c, g.K0 + (size_t)(1 + 2 * S + k) * H + c);
    }
    for (int i = t; i < 2 * S * S / 8 + 2 * S * 2 * S / 8; i += THREADS) {
      if (i < 2 * S * S / 8) {  // q, p: rows k of block b, 4 copies a row
        const int b = i / (S * S / 8), k = (i / 4) % S, c = (i & 3) * 8;
        cp_async16(sm.k1 + (b * S + k) * LK1 + c, g.K1 + (size_t)(b * S + k) * H + b * S + c);
      } else {  // v
        const int j = i - 2 * S * S / 8, k = j >> 3, c = (j & 7) * 8;
        cp_async16(sm.k1 + 2 * S * LK1 + k * LKV + c, g.K1 + (size_t)(2 * S + k) * H + 2 * S + c);
      }
    }
    for (int i = t; i < 2 * S * 16; i += THREADS) sm.k2[(i >> 4) * LK2 + (i & 15)] = fromf<T>(k2_qp(g.K2, i >> 4, i & 15));
    for (int i = t; i < 2 * S * 2 * S; i += THREADS)
      sm.k2[2 * S * LK2 + (i >> 6) * LKV + (i & 63)] = g.K2[(2 * S + (i >> 6)) * NOUT + OV0 + (i & 63)];
  }
  for (int i = t; i < H; i += THREADS) {
    sm.k0d[i] = tof(g.K0[i]);
    sm.b1[i] = tof(g.B1[i]);
    sm.dk0d[i] = 0.f;
    sm.db1[i] = 0.f;
  }
  for (int i = t; i < NOUT; i += THREADS) {
    sm.b2[i] = tof(g.B2[i]);
    sm.db2[i] = 0.f;
  }
  for (int i = t; i < PK_SIZE; i += THREADS) sm.pk[i] = 0.f;
  if (t == 0) {
    for (int i = 0; i < 2 + Smem<T>::NB; ++i) mbar_init(&sm.bar[i], i < 2 ? 1 : Smem<T>::COPIERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_commit();
  cp_async_wait_all();
  sync_all();
  if (warp == PRODUCER) produce_inputs(sm, g, 0, blockIdx.x, A, lg, lane);
  const int copier = t - (THREADS - Smem<T>::COPIERS);  // >= 0: this thread copies rows
  if (copier >= 0) copy_rows(sm, g, 0, 0, 0, copier);

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    constexpr int NB = Smem<T>::NB;
    const int p = it & 1, a0 = tile * A, rb = it % NB, nb = (it + 1) % NB;  // the rows' buffers: this tile's, the next's
    T* const rows = sm.buf[rb];
    T* const x2 = sm.buf[(it + NB - 1) % NB];
    T* const od = sm.x0;
    const bool more = tile + (int)gridDim.x < ntiles;
    // the parities of this tile's and the next tile's copies: buffer b is
    // filled every second (inputs) or NB-th (rows) tile
    const uint32_t in_now = (it >> 1) & 1, in_next = ((it + 1) >> 1) & 1, rows_now = (it / NB) & 1;
    mbar_wait(&sm.bar[p], in_now);
    mbar_wait(&sm.bar[2 + rb], rows_now);
    // ---- the tile's top: the last tile's edge features, backwards, end here
    sync_all();
    if (more && warp == PRODUCER) produce_inputs(sm, g, p ^ 1, tile + gridDim.x, A, lg, lane);
    // nq, stored after h1 (kept in T, so that nothing waits for the load until then)
    const T nqv = t < A * NQ && a0 + t / NQ < g.n_atoms ? g.nq[(size_t)a0 * NQ + t] : fromf<T>(0.f);
    // ---- the next tile's inputs issued; the atoms that reach the loss
    int mine = 0;
    if (warp < A) {
      const T* z = sm.gz[p] + warp * NG;
      for (int i = lane; i < NG; i += 32) mine |= tof(z[i]) != 0.f;
      mine = __any_sync(0xffffffffu, mine);
      if (lane == 0) sm.act[warp] = mine;
    }
    if (warp < 2 * A) {  // dMp2 = dZp . p_n of atom warp / 2, head warp % 2: a lane per s
      const int a = warp >> 1, hh = warp & 1;
      const T* gp = sm.gz[p] + a * NG + NH * S + hh * S + lane;
      const T* C = sm.cen[p] + a * H + S + lane;
      float v = tof(gp[0]) * tof(C[0]) + tof(gp[NH * S]) * tof(C[S]) + tof(gp[2 * NH * S]) * tof(C[2 * S]);
      v = lanes_sum(v, 1, 16);
      if (lane == 0) sm.dm2[a][hh] = v;
    }
    const int any = __syncthreads_or(mine);
    if (!any) {  // no atom of the tile reaches the loss
      if (more && copier >= 0) copy_rows(sm, g, p ^ 1, in_next, nb, copier);
      continue;
    }

    // ---- E = [q_m, |p_m|, <p_n, r>, <p_m, r>], the group's 16 edges --------
    {
      const int r = 32 * qn + lane;
      edge_E(sm, rows, p, e0 + (r >> 3), 4 * (r & 7), lg);
    }
    sync_group(1 + mt);

    // ---- h0 = elu(E K0e + d K0[0] + pa) -------------------------------------
    {
      float acc[4][4] = {};
      gemm<T, 4, H>(acc, [&](FA& a, int k0) { M::a_rows(a, sm.x0, e0, k0, lane); },
                    WB<T>{sm.k0e, LK0, true, wp, seg_off(0), seg_nt(0), 32 * qn, lane});
      const float* pa = sm.pa[p];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + gq + 8 * h, c = 32 * qn + 8 * j + 2 * q;
          const float d = tof(sm.dist[p][e]);
          const float* pr = pa + (e >> lg) * H + c;
          st2(sm.x1 + ti<T>(e, c), elu(acc[j][2 * h] + d * sm.k0d[c] + pr[0]),
              elu(acc[j][2 * h + 1] + d * sm.k0d[c + 1] + pr[1]));
        }
    }
    sync_group(1 + mt);

    // ---- h1 = elu(h0 K1 + B1), K1 block-diagonal ------------------------------
    {
      float acc[4][4] = {};
      if (qn < 2)
        gemm<T, 4, S>(acc, [&](FA& a, int k0) { M::a_rows(a, sm.x1, e0, 32 * qn + k0, lane); },
                      WB<T>{wblk(sm.k1, qn * S * LK1), LK1, true, wp, qn ? seg_off(2) : seg_off(1), seg_nt(1), 0, lane});
      else
        gemm<T, 4, 2 * S>(acc, [&](FA& a, int k0) { M::a_rows(a, sm.x1, e0, 2 * S + k0, lane); },
                          WB<T>{wblk(sm.k1, 2 * S * LK1), LKV, true, wp, seg_off(3), seg_nt(3), 32 * (qn - 2), lane});
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + gq + 8 * h, c = 32 * qn + 8 * j + 2 * q;
          st2(x2 + ti<T>(e, c), elu(acc[j][2 * h] + sm.b1[c]), elu(acc[j][2 * h + 1] + sm.b1[c + 1]));
        }
    }
    sync_group(1 + mt);

    // ---- out = h1 K2 + B2 (rounded to T) and the value sums' dot products ---
    if (t < A * NQ) sm.nq[t] = nqv;
    if (qn == 0) {  // the 12 logit columns
      float acc[2][4] = {};
      gemm<T, 2, 2 * S>(acc, [&](FA& a, int k0) { M::a_rows(a, x2, e0, k0, lane); },
                        WB<T>{sm.k2, LK2, true, wp, seg_off(4), seg_nt(4), 0, lane});
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + gq + 8 * h, c = 8 * j + 2 * q;
          if (c < OV0) st2(od + ti<T>(e, c), acc[j][2 * h] + sm.b2[c], acc[j][2 * h + 1] + sm.b2[c + 1]);
        }
    } else if (qn == 1) {  // dMp3 = dZp . p_m: 8 lanes an edge, 4 columns each, both heads
      const int part = lane & 7, s = 4 * part;
#pragma unroll 1
      for (int e = e0 + (lane >> 3); e < e0 + 16; e += 4) {
        const T* gp = sm.gz[p] + (e >> lg) * NG + NH * S + s;  // x at stride NH * S, head at S
        float d3[NH] = {0.f, 0.f};
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float4 pm = ld4(rows + e * H + S + x * S + s);
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            const float4 gv = ld4(gp + x * NH * S + hh * S);
            d3[hh] += gv.x * pm.x + gv.y * pm.y + gv.z * pm.z + gv.w * pm.w;
          }
        }
        lanes_scatter<2, 1>(d3, lane, 4);  // head (lane / 4) % 2, then over the other 4 lanes
        const float v = lanes_sum(d3[0], 1, 2);
        if ((lane & 3) == 0) sm.dm[e][(lane >> 2) & 1][1] = v;
      }
    } else {  // V0 (qn 2): dMq = dZq . V0; V1 (qn 3): dZp_x . V1
      const int v = qn - 2;
      float acc[4][4] = {};
      gemm<T, 4, 2 * S>(acc, [&](FA& a, int k0) { M::a_rows(a, x2, e0, 2 * S + k0, lane); },
                        WB<T>{wblk(sm.k2, 2 * S * LK2), LKV, true, wp, seg_off(5), seg_nt(5), 32 * v, lane});
      float part[2][NH][3] = {};  // [row g, g + 8][head][x, or 0 for V0]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* z = sm.gz[p] + ((e0 + gq + 8 * h) >> lg) * NG + (v ? NH * S : 0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 8 * j + 2 * q;
          const float v0 = rnd<T>(acc[j][2 * h] + sm.b2[OV0 + S * v + s]);
          const float v1 = rnd<T>(acc[j][2 * h + 1] + sm.b2[OV0 + S * v + s + 1]);
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int x = 0; x < 3; ++x) {
              if (v == 0 && x > 0) break;
              const float2 zz = ld2(z + x * NH * S + hh * S + s);
              part[h][hh][x] += zz.x * v0 + zz.y * v1;
            }
        }
      }
      // over the 4 lanes of a row: lane q keeps index q (V0) or 3q .. 3q + 2 (V1)
      if (v == 0) {
        float w[4] = {part[0][0][0], part[0][1][0], part[1][0][0], part[1][1][0]};
        lanes_scatter<4, 2>(w, lane, 1);
        sm.dm[e0 + gq + 8 * (q >> 1)][q & 1][0] = w[0];
      } else {
        float w[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) w[i] = part[i / 6][(i / 3) % 2][i % 3];
        lanes_scatter<12, 2>(w, lane, 1);
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          const int i = 3 * q + jj;
          sm.tx[e0 + gq + 8 * (i / 6)][(i / 3) % 2][i % 3] = w[jj];
        }
      }
    }
    sync_all();

    // ---- the softmaxes: warps 0-3, one thread per (edge, head) -------------
    if (Smem<T>::NB == 3 && more && copier >= 0) copy_rows(sm, g, p ^ 1, in_next, nb, copier);
    if (warp < 4) {
      const int hh = t >> 6, e = t & 63, a = e >> lg;
      const T* nqa = sm.nq + a * NQ;
      float o[OV0];
#pragma unroll
      for (int k = 0; k < OV0; k += 4) {
        const float4 u = ld4(od + ti<T>(e, k));
        o[k] = u.x, o[k + 1] = u.y, o[k + 2] = u.z, o[k + 3] = u.w;
      }
      float l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < NK; ++k) l[0] += tof(nqa[hh * NK + k]) * o[k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int k = 0; k < NK; ++k) l[1 + c] += tof(nqa[NH * NK + hh * NK + k]) * o[NK + c * NK + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) l[c] *= rsdk;
      float mx[2] = {l[0], fmaxf(l[1], fmaxf(l[2], l[3]))};
      seg_reduce<true>(mx, nn, sm, warp, lane, 0);
      float ex[4];
      ex[0] = expf(l[0] - mx[0]);
#pragma unroll
      for (int c = 1; c < 4; ++c) ex[c] = expf(l[c] - mx[1]);
      float sums[2] = {ex[0], ex[1] + ex[2] + ex[3]};
      seg_reduce<false>(sums, nn, sm, warp, lane, 2);
      float w[4];
      const float i0 = 1.f / sums[0], i1 = 1.f / sums[1];
      w[0] = ex[0] * i0;
#pragma unroll
      for (int c = 1; c < 4; ++c) w[c] = ex[c] * i1;

      // dMq, dMp1 = sum_x r_x (dZp_x . V1), dMp2, dMp3 (the out phase's dots)
      const float rx = tof(sm.rv[p][3 * e]), ry = tof(sm.rv[p][3 * e + 1]), rz = tof(sm.rv[p][3 * e + 2]);
      const float tx[3] = {sm.tx[e][hh][0], sm.tx[e][hh][1], sm.tx[e][hh][2]};
      const float dm[4] = {sm.dm[e][hh][0], rx * tx[0] + ry * tx[1] + rz * tx[2], sm.dm2[a][hh], sm.dm[e][hh][1]};
#pragma unroll
      for (int c = 0; c < 4; ++c) sm.w[e][hh][c] = w[c];
#pragma unroll
      for (int x = 0; x < 3; ++x) sm.drz[e][hh][x] = w[1] * tx[x];
      float u[3] = {w[0] * dm[0], w[1] * dm[1] + w[2] * dm[2] + w[3] * dm[3], w[2]};
      seg_reduce<false>(u, nn, sm, warp, lane, 4);
      float dl[4];
      dl[0] = w[0] * (dm[0] - u[0]) * rsdk;
#pragma unroll
      for (int c = 1; c < 4; ++c) dl[c] = w[c] * (dm[c] - u[1]) * rsdk;
      // the edge's terms of dnq, [head, k][edge] (summed over the atom's edges in the dout phase)
      float* dq = sm.sums + DQ + hh * 6 * TE + e;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        dq[k * TE] = dl[0] * o[k];
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) v += dl[1 + c] * o[NK + c * NK + k];
        dq[(NK + k) * TE] = v;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sm.dl[e][hh][c] = dl[c];
      if ((e & (nn - 1)) == 0) sm.s2[a][hh] = u[2];
    }
    sync_all();

    // ---- dout = [dKq, dKp3, 0, dV0, dV1] in place of out; dB2's sums; dnq ---
    if ((g.flags & 4) && t < 192) {  // dQ0 = sum_j dlq Kq, dQ1 = sum_j,c dlp_c Kp3_c: nn / 4 lanes an entry
      const int P = nn >> 2, part = t & (P - 1), item = t >> (lg - 2);
      const int a = item / (NH * 6), hh = (item / 6) % NH, k = item % 6;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) v += sm.sums[DQ + (hh * 6 + k) * TE + a * nn + 4 * part + i];
      for (int o = 1; o < P; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (part == 0 && a0 + a < g.n_atoms)
        g.dnq[(size_t)(a0 + a) * NQ + (k < NK ? hh * NK + k : NH * NK + hh * NK + k - NK)] = fromf<T>(v);
    }
    {
      const int e = t >> 3, part = t & 7, a = e >> lg, s = 4 * part;
      const T* z = sm.gz[p] + a * NG;
      const float rx = tof(sm.rv[p][3 * e]), ry = tof(sm.rv[p][3 * e + 1]), rz = tof(sm.rv[p][3 * e + 2]);
      float vk[4], v0[4], v1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v0[u] = 0.f, v1[u] = 0.f, vk[u] = 0.f;
        for (int h = 0; h < NH; ++h) {
          v0[u] += sm.w[e][h][0] * tof(z[h * S + s + u]);
          v1[u] += sm.w[e][h][1] * (rx * tof(z[NH * S + h * S + s + u]) + ry * tof(z[2 * NH * S + h * S + s + u]) +
                                    rz * tof(z[3 * NH * S + h * S + s + u]));
        }
        const int j = s + u;
        if (j < OV0) {
          const int c = j < NK ? 0 : 1 + (j - NK) / NK, k = j < NK ? j : (j - NK) % NK;
          const int q0 = j < NK ? 0 : NH * NK;
          for (int h = 0; h < NH; ++h) vk[u] += sm.dl[e][h][c] * tof(sm.nq[a * NQ + q0 + h * NK + k]);
        }
      }
      if (part < 4) st4(od + ti<T>(e, s), make_float4(vk[0], vk[1], vk[2], vk[3]));  // part 3: the zero columns
      st4(od + ti<T>(e, ODV + s), make_float4(v0[0], v0[1], v0[2], v0[3]));
      st4(od + ti<T>(e, ODV + S + s), make_float4(v1[0], v1[1], v1[2], v1[3]));
      // sums over the warp's 4 edges (lanes 8 and 16 apart), then per warp
      float v[12];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = vk[u], v[4 + u] = v0[u], v[8 + u] = v1[u];
      lanes_scatter<12, 2>(v, lane, 8);
      float* sw = sm.sums + warp * 80;
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int i = 3 * (lane >> 3) + jj, u = i & 3;
        if (i >= 4) sw[ODV + (i >= 8 ? S : 0) + s + u] = v[jj];
        else if (part < 3) sw[s + u] = v[jj];
      }
    }
    sync_all();

    // ---- dh1 = dout K2^T; dK2 += h1^T dout; dB2 --------------------------------
    // (the weight-gradient job first: its fragments and dh1's result are not live together)
    if (job >= 4) {  // K2's v block: rows 64 + 16 ((job - 4) % 4), columns 32 ((job - 4) / 4) ..
      const int i0 = 2 * S + 16 * ((job - 4) & 3), n0 = ODV + 32 * ((job - 4) >> 2);
      float* pkj = sm.pk + PK_K2V + (job - 4) * 512;
      float acc[4][4];
      load_frag(acc, pkj, lane);
      gemm<T, 4, TE>(acc, [&](FA& a, int k0) { M::a_cols(a, x2, i0, k0, lane); },
                     [&](FB& b, int k0, int n) { M::b_tile(b, od, k0, n0 + 8 * n, lane); });
      store_frag(acc, pkj, lane);
    } else if (job >= 0) {  // K2's q | p block: rows 16 job .., columns 0 .. 15
      float* pkj = sm.pk + PK_K2 + job * 256;
      float acc[2][4];
      load_frag(acc, pkj, lane);
      gemm<T, 2, TE>(acc, [&](FA& a, int k0) { M::a_cols(a, x2, 16 * job, k0, lane); },
                     [&](FB& b, int k0, int n) { M::b_tile(b, od, k0, 8 * n, lane); });
      store_frag(acc, pkj, lane);
    }
    float hd[4][4] = {};
    if (qn < 2)
      gemm<T, 4, 16>(hd, [&](FA& a, int k0) { M::a_rows(a, od, e0, k0, lane); },
                     WB<T>{sm.k2, LK2, false, wp, seg_off(6), seg_nt(6), 32 * qn, lane});
    else
      gemm<T, 4, 2 * S>(hd, [&](FA& a, int k0) { M::a_rows(a, od, e0, ODV + k0, lane); },
                        WB<T>{wblk(sm.k2, 2 * S * LK2), LKV, false, wp, seg_off(7), seg_nt(7), 32 * (qn - 2), lane});
    if (t < 80 && (t < OV0 || t >= ODV)) {  // dB2: the warps' sums in order
      float v = 0.f;
      for (int w = 0; w < WARPS; ++w) v += sm.sums[w * 80 + t];
      sm.db2[t < OV0 ? t : t - (ODV - OV0)] += v;
    }
    sync_all();
    // ---- dpre1 = dh1 elu'(pre1), in place of h1; dB1's sums per group
    {
      float cs[4][2] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + gq + 8 * h, c = 32 * qn + 8 * j + 2 * q;
          const float2 y = ld2(x2 + ti<T>(e, c));
          const float v0 = hd[j][2 * h] * elu_grad(y.x), v1 = hd[j][2 * h + 1] * elu_grad(y.y);
          st2(x2 + ti<T>(e, c), v0, v1);
          cs[j][0] += v0;
          cs[j][1] += v1;
        }
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = cs[i >> 1][i & 1];
      lanes_scatter<8, 3>(v, lane, 4);  // lane (gq, q) holds (j, u) = (gq / 2, gq % 2)
      sm.sums[mt * H + 32 * qn + 8 * (gq >> 1) + 2 * q + (gq & 1)] = v[0];
    }
    sync_all();

    // ---- dh0 = dpre1 K1^T; dK1 += h0^T dpre1; dB1; E again ------------------
    if (job >= 0) {  // K1's q (jobs 0, 1), p (2, 3) and v (4 .. 11) blocks
      const int i0 = job < 4 ? 16 * job : 2 * S + 16 * ((job - 4) & 3);
      const int n0 = job < 2 ? 0 : job < 4 ? S : 2 * S + 32 * ((job - 4) >> 2);
      float* pkj = sm.pk + job * 512;
      float acc[4][4];
      load_frag(acc, pkj, lane);
      gemm<T, 4, TE>(acc, [&](FA& a, int k0) { M::a_cols(a, sm.x1, i0, k0, lane); },
                     [&](FB& b, int k0, int n) { M::b_tile(b, x2, k0, n0 + 8 * n, lane); });
      store_frag(acc, pkj, lane);
    }
    if (t < H) sm.db1[t] += sm.sums[t] + sm.sums[H + t] + sm.sums[2 * H + t] + sm.sums[3 * H + t];
    edge_E(sm, rows, p, t >> 3, 4 * (t & 7), lg);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) hd[j][i] = 0.f;
    if (qn < 2)
      gemm<T, 4, S>(hd, [&](FA& a, int k0) { M::a_rows(a, x2, e0, 32 * qn + k0, lane); },
                    WB<T>{wblk(sm.k1, qn * S * LK1), LK1, false, wp, qn ? seg_off(9) : seg_off(8), seg_nt(8), 0, lane});
    else
      gemm<T, 4, 2 * S>(hd, [&](FA& a, int k0) { M::a_rows(a, x2, e0, 2 * S + k0, lane); },
                        WB<T>{wblk(sm.k1, 2 * S * LK1), LKV, false, wp, seg_off(10), seg_nt(10), 32 * (qn - 2), lane});
    sync_all();
    // ---- dpre0 = dh0 elu'(pre0) in place of h0; sums of dK0[0], dpa, dd; next rows
    {
      float ck[4][2] = {}, ca[2][4][2] = {}, cd[2] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + gq + 8 * h, c = 32 * qn + 8 * j + 2 * q;
          const float2 y = ld2(sm.x1 + ti<T>(e, c));
          const float v0 = hd[j][2 * h] * elu_grad(y.x), v1 = hd[j][2 * h + 1] * elu_grad(y.y);
          st2(sm.x1 + ti<T>(e, c), v0, v1);
          const float d = tof(sm.dist[p][e]);
          ck[j][0] += d * v0;
          ck[j][1] += d * v1;
          ca[h][j][0] = v0;
          ca[h][j][1] = v1;
          cd[h] += v0 * sm.k0d[c] + v1 * sm.k0d[c + 1];
        }
      // over the 8 lanes of a column: dK0[0] per group, dpa per 8 edges;
      // lane (gq, q) keeps column 8 (gq / 2) + 2 q + gq % 2 of the warp's
      lanes_scatter<8, 3>(*reinterpret_cast<float(*)[8]>(ck), lane, 4);
      lanes_scatter<8, 3>(*reinterpret_cast<float(*)[8]>(ca[0]), lane, 4);
      lanes_scatter<8, 3>(*reinterpret_cast<float(*)[8]>(ca[1]), lane, 4);
      const int c = 32 * qn + 8 * (gq >> 1) + 2 * q + (gq & 1);
      sm.sums[mt * H + c] = ck[0][0];
      sm.sums[(4 + 2 * mt) * H + c] = ca[0][0][0];
      sm.sums[(5 + 2 * mt) * H + c] = ca[1][0][0];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dsum = lanes_sum(cd[h], 1, 2);
        if (q == 0) sm.sums[12 * H + qn * TE + e0 + gq + 8 * h] = dsum;  // dd, per quarter
      }
      if (Smem<T>::NB == 2 && more) copy_rows(sm, g, p ^ 1, in_next, nb, copier);
    }
    sync_all();

    // ---- dK0e += E^T dpre0; dK0[0], dpa, dd ----------------------------------
    {
      const int i0 = 16 * (warp & 7), n0 = 64 * (warp >> 3);
      gemm<T, 8, TE>(gk0, [&](FA& a, int k0) { M::a_cols(a, sm.x0, i0, k0, lane); },
                     [&](FB& b, int k0, int n) { M::b_tile(b, sm.x1, k0, n0 + 8 * n, lane); });
    }
    if (t < H) sm.dk0d[t] += sm.sums[t] + sm.sums[H + t] + sm.sums[2 * H + t] + sm.sums[3 * H + t];
    for (int i = t; i < A * H; i += THREADS) {
      const int a = i >> 7, c = i & (H - 1);
      if (!sm.act[a]) continue;
      float v = 0.f;
      for (int k = a * (nn >> 3); k < (a + 1) * (nn >> 3); ++k) v += sm.sums[4 * H + k * H + c];
      g.dpa[(size_t)(a0 + a) * H + c] = v;
    }
    if ((g.flags & 1) && t < TE && a0 + (t >> lg) < g.n_atoms) {
      const float* sd = sm.sums + 12 * H + t;
      g.dd[(size_t)a0 * nn + t] = fromf<T>(sd[0] + sd[TE] + sd[2 * TE] + sd[3 * TE]);
    }
    sync_all();

    // ---- dE = dpre0 K0e^T, in place of E ------------------------------------
    {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) hd[j][i] = 0.f;
      gemm<T, 4, H>(hd, [&](FA& a, int k0) { M::a_rows(a, sm.x1, e0, k0, lane); },
                    WB<T>{sm.k0e, LK0, false, wp, seg_off(11), seg_nt(11), 32 * qn, lane});
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st2(sm.x0 + ti<T>(e0 + gq + 8 * h, 32 * qn + 8 * j + 2 * q), hd[j][2 * h], hd[j][2 * h + 1]);
    }
    sync_all();

    // ---- the edge features, backwards: 8 threads an edge, 4 columns each -----
    {
      const int e = t >> 3, part = t & 7, s = 4 * part, a = e >> lg;  // a warp's 4 edges: one atom
      float drv[3] = {0.f, 0.f, 0.f};
      if (sm.act[a]) {
        const T* x0 = sm.x0;
        const float4 dq = ld4(x0 + ti<T>(e, s)), dn = ld4(x0 + ti<T>(e, S + s));
        const float4 dpp = ld4(x0 + ti<T>(e, 2 * S + s)), dpn = ld4(x0 + ti<T>(e, 3 * S + s));
        const float4 p4[3] = {ld4(rows + e * H + S + s), ld4(rows + e * H + 2 * S + s),
                              ld4(rows + e * H + 3 * S + s)};
        const float r3[3] = {tof(sm.rv[p][3 * e]), tof(sm.rv[p][3 * e + 1]), tof(sm.rv[p][3 * e + 2])};
        const float w30 = sm.w[e][0][3], w31 = sm.w[e][1][3];
        float* row = g.dqp + (size_t)sm.ids[p][e] * H;
        red4(row + s, dq);
        float gn[4];
        const float dnv[4] = {dn.x, dn.y, dn.z, dn.w}, ppv[4] = {dpp.x, dpp.y, dpp.z, dpp.w},
                    pnv[4] = {dpn.x, dpn.y, dpn.z, dpn.w};
        float pv[3][4];
#pragma unroll
        for (int x = 0; x < 3; ++x) pv[x][0] = p4[x].x, pv[x][1] = p4[x].y, pv[x][2] = p4[x].z, pv[x][3] = p4[x].w;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float sq = pv[0][u] * pv[0][u] + pv[1][u] * pv[1][u] + pv[2][u] * pv[2][u];
          gn[u] = sq >= 1e-36f ? dnv[u] * rsqrtf(sq) : 0.f;  // safe_norm's floor: no gradient
        }
        const T* C = sm.cen[p] + a * H;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const T* gx = sm.gz[p] + a * NG + NH * S + x * NH * S;
          const float4 c4 = ld4(C + S + x * S + s), g0 = ld4(gx + s), g1 = ld4(gx + S + s);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, gv0[4] = {g0.x, g0.y, g0.z, g0.w}, gv1[4] = {g1.x, g1.y, g1.z, g1.w};
          float val[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            val[u] = gn[u] * pv[x][u] + pnv[u] * r3[x] + w30 * gv0[u] + w31 * gv1[u];
            drv[x] += ppv[u] * cv[u] + pnv[u] * pv[x][u];
          }
          red4(row + S + x * S + s, make_float4(val[0], val[1], val[2], val[3]));
        }
      }
      if (g.flags & 2) {
#pragma unroll
        for (int x = 0; x < 3; ++x) drv[x] = lanes_sum(drv[x], 1, 4);
        if (part == 0 && sm.act[a])
          for (int x = 0; x < 3; ++x)
            g.dr[((size_t)a0 * nn + e) * 3 + x] = fromf<T>(drv[x] + sm.drz[e][0][x] + sm.drz[e][1][x]);
      }
    }
    // the own rows: dp_n from the projections <p_n, r> and from Z2; P
    // neighbouring lanes per (atom, x, 4 columns), 4 edges each
    if (t < 384) {
      const int P = nn >> 2, part = t & (P - 1), item = t >> (lg - 2);
      const int a = item / 24, x = (item >> 3) % 3, s = 4 * (item & 7);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sm.act[a])
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = a * nn + 4 * part + k;
          const float4 d = ld4(sm.x0 + ti<T>(e, 2 * S + s));
          const float r = tof(sm.rv[p][3 * e + x]);
          v.x += d.x * r, v.y += d.y * r, v.z += d.z * r, v.w += d.w * r;
        }
      for (int o = 1; o < P; o <<= 1) {
        v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
        v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
        v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
        v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
      }
      if (part == 0 && sm.act[a]) {
        const T* gx = sm.gz[p] + a * NG + NH * S + x * NH * S + s;
        v.x += sm.s2[a][0] * tof(gx[0]) + sm.s2[a][1] * tof(gx[S]);
        v.y += sm.s2[a][0] * tof(gx[1]) + sm.s2[a][1] * tof(gx[S + 1]);
        v.z += sm.s2[a][0] * tof(gx[2]) + sm.s2[a][1] * tof(gx[S + 2]);
        v.w += sm.s2[a][0] * tof(gx[3]) + sm.s2[a][1] * tof(gx[S + 3]);
        red4(g.dqp + (size_t)(g.row0 + a0 + a) * H + S + x * S + s, v);
      }
    }
  }

  // ---- the block's partial weight gradients -------------------------------
  sync_all();
  float* part = g.part + (size_t)blockIdx.x * P_SIZE;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[P_K0E + (16 * (warp & 7) + gq + 8 * (i >> 1)) * H + 64 * (warp >> 3) + 8 * j + 2 * q + (i & 1)] = gk0[j][i];
  for (int i = t; i < PK_SIZE; i += THREADS) {
    const int d = pk_dense(i);
    if (d >= 0) part[d] = sm.pk[i];
  }
  for (int i = t; i < H; i += THREADS) {
    part[P_K0D + i] = sm.dk0d[i];
    part[P_B1 + i] = sm.db1[i];
  }
  for (int i = t; i < NOUT; i += THREADS) part[P_B2 + i] = sm.db2[i];
}

// Per chunk of AG atoms: dK0[1:2S+1] += X_n^T dpa and dB0 += sum dpa
// (thread c owns column c, summed over the block's chunks in order), and
// dX_n = dpa K0[1:2S+1]^T (thread j % 64 owns column j of X_n, for every
// other atom pair; K0[1:2S+1] staged transposed once per block), whose q
// part and |p| part go to the atom's own row.
constexpr int AG = 16;

template <typename T>
__global__ void __launch_bounds__(H) edge_bwd_atom_grad(const Args<T> g) {
  __shared__ __align__(16) float k0t[H][2 * S];  // K0[1 + j][c] at [c][j]
  __shared__ __align__(16) float xn[2 * S][AG];
  __shared__ __align__(16) float dp[AG][H];
  const int c = threadIdx.x;
  for (int i = c; i < 2 * S * H; i += H) k0t[i % H][i / H] = tof(g.K0[H + i]);
  float acc[2 * S] = {}, db = 0.f;
  for (int a0 = blockIdx.x * AG; a0 < g.n_atoms; a0 += gridDim.x * AG) {
    __syncthreads();
    for (int i = c; i < AG * 2 * S; i += H) {
      const int a = i % AG, s = i / AG;
      float v = 0.f;
      if (a0 + a < g.n_atoms) {
        const T* row = g.qp + (size_t)(g.row0 + a0 + a) * H;
        v = s < S ? tof(row[s]) : norm3(tof(row[s]), tof(row[S + s]), tof(row[2 * S + s]));
      }
      xn[s][a] = v;
    }
    for (int i = c; i < AG * H; i += H) {
      const int a = i / H;
      dp[a][i % H] = a0 + a < g.n_atoms ? g.dpa[(size_t)a0 * H + i] : 0.f;
    }
    __syncthreads();
    for (int a = 0; a < AG; ++a) {
      const float v = dp[a][c];
      db += v;
#pragma unroll
      for (int j = 0; j < 2 * S; ++j) acc[j] = fmaf(xn[j][a], v, acc[j]);
    }
    const int j = c % (2 * S);
    for (int a = c / (2 * S); a < AG; a += H / (2 * S)) {
      const int atom = a0 + a;
      if (atom >= g.n_atoms) break;
      float v = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) v = fmaf(dp[a][k], k0t[k][j], v);
      if (v == 0.f) continue;
      float* row = g.dqp + (size_t)(g.row0 + atom) * H;
      if (j < S) {
        atomicAdd(row + j, v);
      } else {
        const int s = j - S;
        const T* src = g.qp + (size_t)(g.row0 + atom) * H;
        const float px = tof(src[S + s]), py = tof(src[2 * S + s]), pz = tof(src[3 * S + s]);
        const float sq = px * px + py * py + pz * pz;
        if (sq >= 1e-36f) {  // safe_norm's floor: no gradient below it
          const float gn = v * rsqrtf(sq);
          atomicAdd(row + S + s, gn * px);
          atomicAdd(row + 2 * S + s, gn * py);
          atomicAdd(row + 3 * S + s, gn * pz);
        }
      }
    }
  }
  float* part = g.apart + (size_t)blockIdx.x * AP_SIZE;
#pragma unroll
  for (int j = 0; j < 2 * S; ++j) part[AP_K0X + j * H + c] = acc[j];
  part[AP_B0 + c] = db;
}

// The weight gradients: each output element the sum of the blocks' partials
// in block order; zero off the diagonal blocks of K1 and K2.
constexpr int N_K0 = (1 + 6 * S) * H, N_OUT = N_K0 + H + H * H + H + H * NOUT + NOUT;

__device__ __forceinline__ int blk(int i, int w0, int w1) { return i < w0 ? 0 : i < w0 + w1 ? 1 : 2; }

template <typename T>
__global__ void edge_bwd_reduce(const float* __restrict__ part, int np, const float* __restrict__ apart, int nap,
                                T* dK0, T* dB0, T* dK1, T* dB1, T* dK2, T* dB2) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* src = part;
  int off = -1, nb = np, stride = P_SIZE;
  T* dst;
  if (i < N_K0) {
    const int row = i / H, col = i % H;
    dst = dK0 + i;
    if (row == 0) {
      off = P_K0D + col;
    } else if (row <= 2 * S) {
      src = apart, nb = nap, stride = AP_SIZE, off = AP_K0X + (row - 1) * H + col;
    } else {
      off = P_K0E + (row - 1 - 2 * S) * H + col;
    }
  } else if ((i -= N_K0) < H) {
    dst = dB0 + i, src = apart, nb = nap, stride = AP_SIZE, off = AP_B0 + i;
  } else if ((i -= H) < H * H) {
    dst = dK1 + i;
    if (blk(i / H, S, S) == blk(i % H, S, S)) off = P_K1 + i;
  } else if ((i -= H * H) < H) {
    dst = dB1 + i, off = P_B1 + i;
  } else if ((i -= H) < H * NOUT) {
    dst = dK2 + i;
    if (blk(i / NOUT, S, S) == blk(i % NOUT, NK, 3 * NK)) off = P_K2 + i;
  } else if ((i -= H * NOUT) < NOUT) {
    dst = dB2 + i, off = P_B2 + i;
  } else {
    return;
  }
  float v = 0.f;
  if (off >= 0)
    for (int b = 0; b < nb; ++b) v += src[(size_t)b * stride + off];
  *dst = fromf<T>(v);
}

__global__ void edge_bwd_cast(const float* __restrict__ src, __nv_bfloat16* dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

// Grid sizes and the scratch layout (fp32 offsets, multiples of 4) of one call.
struct Plan {
  int g1, g2;
  size_t pa, dpa, part, apart, wpack, table, floats;
};

template <typename T>
cudaError_t plan(int n_atoms, int nn, int n_table, Plan& p) {
  // blocks of the tile kernel that fit each card at once, and its SMs, set
  // up at the first call there
  static int cap[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    err = cudaFuncSetAttribute(edge_bwd_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem<T>));
    if (err != cudaSuccess) return err;
    int n = 0, per = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, edge_bwd_tile<T>, THREADS, sizeof(Smem<T>));
    sms[dev] = n;
    cap[dev] = n * (per > 0 ? per : 1);
  }
  const int A = TE / nn, ntiles = (n_atoms + A - 1) / A, nchunks = (n_atoms + AG - 1) / AG;
  p.g1 = ntiles < cap[dev] ? ntiles : cap[dev];
  p.g2 = nchunks < 2 * sms[dev] ? nchunks : 2 * sms[dev];
  const auto up4 = [](size_t n) { return (n + 3) / 4 * 4; };
  size_t o = 0;
  p.pa = o, o += up4((size_t)n_atoms * H);
  p.dpa = o, o += up4((size_t)n_atoms * H);
  p.part = o, o += up4((size_t)p.g1 * P_SIZE);
  p.apart = o, o += up4((size_t)p.g2 * AP_SIZE);
  p.wpack = o, o += sizeof(T) == 4 ? WPACK_FLOATS : 0;
  p.table = o, o += sizeof(T) == 2 ? (size_t)n_table * H : 0;
  p.floats = o;
  return cudaSuccess;
}

template <typename T>
int launch(Args<T> a, void* dqp, void* dK0, void* dB0, void* dK1, void* dB1, void* dK2, void* dB2, float* scratch,
           long long scratch_floats, int n_table, cudaStream_t st) {
  Plan p;
  cudaError_t err = plan<T>(a.n_atoms, a.nn, n_table, p);
  if (err != cudaSuccess) return (int)err;
  if (scratch_floats < (long long)p.floats) return (int)cudaErrorInvalidValue;
  a.pa = scratch + p.pa;
  a.dpa = scratch + p.dpa;
  a.part = scratch + p.part;
  a.apart = scratch + p.apart;
  a.wpack = scratch + p.wpack;
  a.dqp = sizeof(T) == 4 ? static_cast<float*>(dqp) : scratch + p.table;
  const size_t n = a.n_atoms;
  cudaMemsetAsync(a.dqp, 0, (size_t)n_table * H * sizeof(float), st);
  cudaMemsetAsync(a.dpa, 0, n * H * sizeof(float), st);
  if (a.flags & 1) cudaMemsetAsync(a.dd, 0, n * a.nn * sizeof(T), st);
  if (a.flags & 2) cudaMemsetAsync(a.dr, 0, n * a.nn * 3 * sizeof(T), st);
  if (a.flags & 4) cudaMemsetAsync(a.dnq, 0, n * NQ * sizeof(T), st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n > 0) {
    edge_bwd_atom_term<T><<<(a.n_atoms + AT - 1) / AT, H, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if constexpr (sizeof(T) == 4) {
      edge_bwd_pack<T><<<(SLOTS * 32 + 255) / 256, 256, 0, st>>>(a, reinterpret_cast<float2*>(scratch + p.wpack));
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    edge_bwd_tile<T><<<p.g1, THREADS, sizeof(Smem<T>), st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    edge_bwd_atom_grad<T><<<p.g2, H, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  edge_bwd_reduce<T><<<(N_OUT + 255) / 256, 256, 0, st>>>(
      a.part, n > 0 ? p.g1 : 0, a.apart, n > 0 ? p.g2 : 0, static_cast<T*>(dK0), static_cast<T*>(dB0),
      static_cast<T*>(dK1), static_cast<T*>(dB1), static_cast<T*>(dK2), static_cast<T*>(dB2));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (sizeof(T) == 2) {
    edge_bwd_cast<<<264, 256, 0, st>>>(a.dqp, static_cast<__nv_bfloat16*>(dqp), (size_t)n_table * H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int launch_as(const void* const* in, void* const* out, float* scratch, int n_atoms, int nn, int row0, int n_table,
              int flags, long long scratch_floats, cudaStream_t st) {
  Args<T> a{};
  a.qp = static_cast<const T*>(in[0]);
  a.ids = static_cast<const int*>(in[1]);
  a.dist = static_cast<const T*>(in[2]);
  a.rvec = static_cast<const T*>(in[3]);
  a.nq = static_cast<const T*>(in[4]);
  a.K0 = static_cast<const T*>(in[5]);
  a.B0 = static_cast<const T*>(in[6]);
  a.K1 = static_cast<const T*>(in[7]);
  a.B1 = static_cast<const T*>(in[8]);
  a.K2 = static_cast<const T*>(in[9]);
  a.B2 = static_cast<const T*>(in[10]);
  a.gzq = static_cast<const T*>(in[11]);
  a.gzp = static_cast<const T*>(in[12]);
  a.dd = static_cast<T*>(out[1]);
  a.dr = static_cast<T*>(out[2]);
  a.dnq = static_cast<T*>(out[3]);
  a.n_atoms = n_atoms, a.nn = nn, a.row0 = row0, a.flags = flags;
  return launch<T>(a, out[0], out[4], out[5], out[6], out[7], out[8], out[9], scratch, scratch_floats, n_table, st);
}

}  // namespace

// The fp32 scratch (in floats) that edge_attention_bwd needs on the current
// device for these sizes: pa and dpa, the blocks' partials, in fp32 the
// weights in fragment order and, in bf16, the fp32 table gradient.
extern "C" long long edge_attention_bwd_scratch(int dtype, int n_atoms, int nn, int n_table) {
  Plan p;
  cudaError_t err = dtype == 0 ? plan<float>(n_atoms, nn, n_table, p) : plan<__nv_bfloat16>(n_atoms, nn, n_table, p);
  return err == cudaSuccess ? (long long)p.floats : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (every floating input and output). The
// inputs are the forward's (qp a table of n_table >= row0 + n_atoms rows,
// the atoms its rows row0 .. row0 + n_atoms; ids [n_atoms, nn] any rows of
// it; nn 8, 16, 32 or 64) and dZq [n_atoms, 64], dZp [n_atoms, 192]; qp,
// ids, d, r, K0, K1, dZq and dZp 16-byte aligned (they are copied 16 bytes
// at a time). The outputs: dqp [n_table, 128], dd, dr, dnq (written
// where flags' bits 1, 2, 4 ask), dK0 .. dB2 in the weights' shapes.
// scratch holds scratch_floats fp32 values, at least
// edge_attention_bwd_scratch's count, 16-byte aligned.
extern "C" int edge_attention_bwd(int dtype, const void* qp, const void* ids, const void* d, const void* r,
                                  const void* nq, const void* K0, const void* B0, const void* K1, const void* B1,
                                  const void* K2, const void* B2, const void* gzq, const void* gzp, void* dqp,
                                  void* dd, void* dr, void* dnq, void* dK0, void* dB0, void* dK1, void* dB1,
                                  void* dK2, void* dB2, void* scratch, int n_atoms, int nn, int row0, int n_table,
                                  int flags, int scratch_floats, void* stream) {
  if (n_atoms < 0 || (nn != 8 && nn != 16 && nn != 32 && nn != 64)) return (int)cudaErrorInvalidValue;
  if (row0 < 0 || n_table < row0 + n_atoms) return (int)cudaErrorInvalidValue;
  const void* in[13] = {qp, ids, d, r, nq, K0, B0, K1, B1, K2, B2, gzq, gzp};
  const void* copied[] = {qp, ids, d, r, K0, K1, gzq, gzp, scratch};
  for (const void* x : copied)
    if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorMisalignedAddress;
  void* out[10] = {dqp, dd, dr, dnq, dK0, dB0, dK1, dB1, dK2, dB2};
  float* s = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_as<float>(in, out, s, n_atoms, nn, row0, n_table, flags, scratch_floats, st);
  if (dtype == 1)
    return launch_as<__nv_bfloat16>(in, out, s, n_atoms, nn, row0, n_table, flags, scratch_floats, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
