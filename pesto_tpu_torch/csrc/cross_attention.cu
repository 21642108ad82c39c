// Cross attention of the dimer's CrossStateUpdateLayer (models/extras.py)
// as CUDA for Hopper (sm_90a): every real atom of a structure attends over
// every real atom of its partner, both directions of every pair of a chunk
// in one launch.
//
// It replaces no TPU kernel: the JAX package computes this layer as XLA
// einsums (pesto_tpu/models/extras.py), and the port did the same in plain
// torch until the dimer got a batched path. That path materialised the
// [n_a * cNh, n_b] float32 logits of each direction in each layer and read
// them three more times (bias, softmax, values): 537 MB at 8192 x 8192 atoms,
// and a batch of unequal pairs could not be one einsum at all.
//
// What it computes, per query row i of segment s (the rows offsets[s] ..
// offsets[s] + counts[s] of the table) and head h, over the rows j of the
// partner segment t = partner[s]:
//
//   qh[i, h * S + c] = sum_j softmax_j(Q[i, h, :] . K[j, :] / sqrt(cNk)) V[j, c]
//
// Rows outside every segment (sinks, padding) are left to the caller, who
// zeroes the output first; a segment whose partner has no row gives zeros.
//
// What bounds it. Per (query row, partner row): 2 heads x (3 + 32)
// multiply-adds and 2 exponentials; per row read once only 6 + 3 + 32
// floats. So it is bound by operations, ~280 flops a pair both ways, far
// above the card's ~20 flops a byte, and beside them by the exponentials'
// unit (16 a clock an SM against 128 fp32 multiply-adds). The sums run in
// fp32 on the CUDA cores (the key width is 3, and the values' products are
// rank-1 updates of one row's two heads).
//
// Design.
//   - A block takes BQ = 32 query rows of one segment and walks the
//     partner's rows in tiles of KT = 128 keys, staged in shared memory by
//     cp.async, two stages: the next tile's copy runs under this tile's sums.
//   - Its 8 warps are 2 row warps x G = 4 key groups: each group walks a
//     quarter of every tile, so 4x more warps share the SM at a segment's
//     rows, and the groups' partial softmaxes are merged through shared
//     memory at the end.
//   - A thread holds one query row, both heads, and C = 16 of the 32 value
//     columns (lanes l and l + 16 share a row): 32 accumulators of the
//     tiles so far and 32 of this tile, two blocks an SM. Each key costs
//     the thread one 16-byte load of K and four of V (the warp reads two
//     distinct addresses: broadcasts), 6 + 32 fma and 2 exponentials.
//   - Keys go KC = 8 at a time: their logits, one check of the exponent's
//     reference, then 16 independent exponentials and the value sums. The
//     softmax is online with a lazy maximum: the reference m moves (and the
//     sums are rescaled) only where a logit passes it by more than 2^LAZY,
//     so after the first keys a step costs no rescale, and the weights
//     2^(s - m) stay below 2^LAZY. The logits are taken in base 2 (Q scaled
//     by log2(e) / sqrt(cNk) once), exponentials by ex2.approx.
//   - Each tile's sums start from zero and join the totals at the tile's
//     end, so no float32 sum runs over more than a tile's 32 keys of a
//     group before it is added: one running sum per thread read 1.9e-5 of
//     the output's scale from the plain version at 32767 x 2000 atoms.
//   - The grid's rows of segments run last to first: the dimer puts each
//     pair's smaller side last, and its blocks, which walk the larger
//     partner, start first instead of trailing.
//   - No [rows, keys] tensor exists anywhere: the logits live in registers.
//
// Grid: (ceil(max_rows / BQ), segments); blocks past their segment's count
// return at once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 32;   // value width, and each head's output
constexpr int NH = 2;   // query heads (cNh)
constexpr int NK = 3;   // key width (cNk)
constexpr int SPLIT = 2;               // threads that share a row's value columns
constexpr int C = S / SPLIT;           // value columns a thread sums
constexpr int LANES = 32 / SPLIT;      // lanes of one column part (one row each)
constexpr int ROW_WARPS = 2;
constexpr int BQ = ROW_WARPS * LANES;  // query rows a block
constexpr int G = 4;                   // key groups a block
constexpr int TPG = ROW_WARPS * 32;    // threads of a key group
constexpr int THREADS = TPG * G;       // 256
constexpr int KT = 128;                // keys a stage
constexpr int KG = KT / G;             // keys a group takes of a stage
constexpr int KC = 8;                  // keys a step
constexpr int STAGES = 2;
constexpr float LAZY = 8.0f;           // log2 of the largest weight before a rescale
constexpr int ACC = NH * C;            // accumulators of a thread
constexpr int PART = ACC + 2 * NH;     // a thread's partial: sums, then m and l of each head
constexpr int TILE_BYTES = STAGES * KT * (S + 4) * 4;
constexpr int MERGE_BYTES = (G - 1) * PART * TPG * 4;
constexpr int SMEM = TILE_BYTES > MERGE_BYTES ? TILE_BYTES : MERGE_BYTES;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N keys of a thread's row: their logits, one check of the exponent's
// reference against the step's largest logit, then the weights (N x NH
// independent exponentials) and the value sums of this tile (tl, tacc).
template <int N>
__device__ __forceinline__ void keys(const float4* kp, const float4* vp, const float (&q)[NH][NK],
                                     float (&m)[NH], float (&l)[NH], float (&tl)[NH],
                                     float (&acc)[NH][C], float (&tacc)[NH][C]) {
  float s[N][NH], mx[NH];
  bool up = false;
#pragma unroll
  for (int h = 0; h < NH; ++h) mx[h] = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float4 kv = kp[j];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      s[j][h] = fmaf(q[h][2], kv.z, fmaf(q[h][1], kv.y, q[h][0] * kv.x));
      mx[h] = fmaxf(mx[h], s[j][h]);
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) up |= mx[h] > m[h] + LAZY;
  if (up) {  // rare after the first keys: move the reference and rescale
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (mx[h] > m[h]) {
        const float a = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= a;
        tl[h] *= a;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[h][c] *= a;
          tacc[h][c] *= a;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float p[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      p[h] = ex2(s[j][h] - m[h]);
      tl[h] += p[h];
    }
    const float4* vr = vp + j * (S / 4);
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 v = vr[c4];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        tacc[h][4 * c4 + 0] = fmaf(p[h], v.x, tacc[h][4 * c4 + 0]);
        tacc[h][4 * c4 + 1] = fmaf(p[h], v.y, tacc[h][4 * c4 + 1]);
        tacc[h][4 * c4 + 2] = fmaf(p[h], v.z, tacc[h][4 * c4 + 2]);
        tacc[h][4 * c4 + 3] = fmaf(p[h], v.w, tacc[h][4 * c4 + 3]);
      }
    }
  }
}

// Q [N, NH, NK], K [N, NK], V [N, S] (16-byte aligned), out [N, NH * S]
// (head-major, zeroed by the caller); offsets, counts, partner [segments].
__global__ void __launch_bounds__(THREADS, 2)
cross_attention_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                       const float4* __restrict__ V4, const int* __restrict__ offsets,
                       const int* __restrict__ counts, const int* __restrict__ partner,
                       float* __restrict__ out, float qscale) {
  extern __shared__ __align__(16) float4 smem[];
  float4* Vs = smem;                          // [STAGES][KT][S / 4]
  float4* Ks = smem + STAGES * KT * (S / 4);  // [STAGES][KT], w unused

  const int seg = gridDim.y - 1 - blockIdx.y;  // the last segments first
  const int count = counts[seg];
  const int q0 = blockIdx.x * BQ;
  if (q0 >= count) return;  // the whole block
  const int qoff = offsets[seg];
  const int t_seg = partner[seg];
  const int koff = offsets[t_seg];
  const int kcount = counts[t_seg];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / ROW_WARPS;
  const int tid = (warp % ROW_WARPS) * 32 + lane;  // the thread's place in its group
  const int row = q0 + (warp % ROW_WARPS) * LANES + lane % LANES;
  const int col0 = (lane / LANES) * C;

  float q[NH][NK];
  const float* qr = Q + (size_t)(qoff + row) * (NH * NK);
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int k = 0; k < NK; ++k) q[h][k] = row < count ? qr[h * NK + k] * qscale : 0.f;
  // the sums over the tiles so far (acc, l) and over this tile (tacc, tl)
  float acc[NH][C], tacc[NH][C], m[NH], l[NH], tl[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[h][c] = 0.f;
  }

  const int ntiles = (kcount + KT - 1) / KT;
  auto issue = [&](int t) {
    const int kb = t * KT;
    const int n = min(KT, kcount - kb);
    float4* vs = Vs + (t & 1) * KT * (S / 4);
    float* ks = reinterpret_cast<float*>(Ks + (t & 1) * KT);
    const float4* vsrc = V4 + (size_t)(koff + kb) * (S / 4);
    for (int i = threadIdx.x; i < n * (S / 4); i += THREADS) cp_async16(vs + i, vsrc + i);
    const float* ksrc = K + (size_t)(koff + kb) * NK;
    for (int i = threadIdx.x; i < n * NK; i += THREADS) cp_async4(ks + (i / NK) * 4 + i % NK, ksrc + i);
    cp_commit();
  };

  if (ntiles > 0) issue(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      issue(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kb = group * KG;
    const int nk = min(KG, kcount - t * KT - kb);  // this group's keys of the tile (may be <= 0)
    const float4* ks = Ks + (t & 1) * KT + kb;
    const float4* vs = Vs + (t & 1) * KT * (S / 4) + kb * (S / 4) + col0 / 4;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      tl[h] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) tacc[h][c] = 0.f;
    }
    int j = 0;
    for (; j + KC <= nk; j += KC) keys<KC>(ks + j, vs + j * (S / 4), q, m, l, tl, acc, tacc);
    for (; j < nk; ++j) keys<1>(ks + j, vs + j * (S / 4), q, m, l, tl, acc, tacc);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      l[h] += tl[h];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[h][c] += tacc[h][c];
    }
    __syncthreads();  // the stage is refilled by the next iteration's issue
  }

  // ---- merge the key groups' partial softmaxes; group 0 writes the rows
  float* part = reinterpret_cast<float*>(smem);  // [G - 1][PART][TPG]
  if (group > 0) {
    float* mine = part + (size_t)(group - 1) * PART * TPG + tid;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int c = 0; c < C; ++c) mine[(h * C + c) * TPG] = acc[h][c];
      mine[(ACC + 2 * h) * TPG] = m[h];
      mine[(ACC + 2 * h + 1) * TPG] = l[h];
    }
  }
  __syncthreads();
  if (group > 0 || row >= count) return;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    // group g + 1's m of this head at ml[g * PART * TPG], its l one TPG on
    const float* ml = part + (size_t)(ACC + 2 * h) * TPG + tid;
    float mt = m[h];
#pragma unroll
    for (int g = 0; g < G - 1; ++g) mt = fmaxf(mt, ml[(size_t)g * PART * TPG]);
    float sc[G];
    sc[0] = mt == -INFINITY ? 0.f : ex2(m[h] - mt);
    float lt = l[h] * sc[0];
#pragma unroll
    for (int g = 0; g < G - 1; ++g) {
      sc[g + 1] = mt == -INFINITY ? 0.f : ex2(ml[(size_t)g * PART * TPG] - mt);
      lt = fmaf(ml[(size_t)g * PART * TPG + TPG], sc[g + 1], lt);
    }
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    float4* dst = reinterpret_cast<float4*>(out + (size_t)(qoff + row) * (NH * S) + h * S + col0);
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * c4 + e;
        float a = acc[h][c] * sc[0];
#pragma unroll
        for (int g = 0; g < G - 1; ++g) a = fmaf(part[((size_t)g * PART + h * C + c) * TPG + tid], sc[g + 1], a);
        v[e] = a * inv;
      }
      dst[c4] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// segments in 1 .. 65535; max_rows bounds every counts[s]; the other
// arguments as the kernel's.
extern "C" int cross_attention(const void* Q, const void* K, const void* V, const void* offsets,
                               const void* counts, const void* partner, void* out, int segments,
                               int max_rows, void* stream) {
  if (segments <= 0 || max_rows <= 0) return 0;
  if (segments > 65535 || reinterpret_cast<size_t>(V) % 16 != 0 || reinterpret_cast<size_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // the block's shared memory may pass 48 KB; set at each launch, as the
  // attribute belongs to the current device
  const cudaError_t e =
      cudaFuncSetAttribute(cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const float qscale = 1.4426950408889634f / sqrtf((float)NK);  // log2(e) / sqrt(cNk)
  const dim3 grid((unsigned)((max_rows + BQ - 1) / BQ), (unsigned)segments);
  cross_attention_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const float*>(K), static_cast<const float4*>(V),
      static_cast<const int*>(offsets), static_cast<const int*>(counts), static_cast<const int*>(partner),
      static_cast<float*>(out), qscale);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
