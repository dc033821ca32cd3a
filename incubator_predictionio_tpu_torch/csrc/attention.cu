// Causal multi-head attention of the sequential recommender, written by hand
// for Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// One templated forward kernel and two templated backward kernels, written
// for two TPU kernels; only K4 instantiates them now. K5 (the library flash
// kernel's counterpart) was redesigned for Hopper in csrc/flash_attention.cu;
// its flag values (kTwoPass = false, kSmallHead = false) are no longer
// compiled. What the template was written for:
//
// K4  pio_causal_mha_small_head  replaces incubator_predictionio_tpu/ops/
//                                attention.py causal_mha_small_head (Pallas
//                                _fwd_kernel): two passes. Pass 1 walks the
//                                key tiles for each row's max m and sum l
//                                (fp32); pass 2 recomputes the scores, forms
//                                p = exp(s - m) / l in fp32, rounds p to bf16
//                                (round to nearest even, as astype(bfloat16))
//                                and accumulates p.v in fp32 — the TPU
//                                kernel's rounding, at the cost of one extra
//                                q.k^T.
// K5  (kTwoPass = false)         replaced the library Pallas flash_attention
//                                that incubator_predictionio_tpu/parallel/
//                                ring.py causal_attention calls for long
//                                sequences: one pass of online softmax, a
//                                running max and sum, the fp32 accumulator
//                                rescaled by exp(m_old - m_new), p rounded to
//                                bf16 before PV, one division by l at the end.
//
// Both forward entry points take optional m and l pointers (null when
// serving): given them, the kernel writes each row's max m and sum l (fp32
// [B, H, L]) beside out — the residuals the backward reads (K4: pass 1's;
// K5: the final running ones, which the library kernel saves too). They are
// stored after the output and change nothing of it: out is bitwise the same.
//
// Two templated backward kernels, one flag (kSmallHead), serve both TPU
// kernels' backwards:
//
// K4 bwd  pio_causal_mha_small_head_bwd  replaces incubator_predictionio_tpu/
//                                ops/attention.py _mha_bwd (Pallas
//                                _bwd_kernel): p = exp(s - m) / l in fp32, the
//                                row term rowsum(dp . p) from fp32 p and dp.
//                                The TPU kernel recomputes the whole row's
//                                softmax; here m and l come from the forward
//                                (the same numbers its pass 1 computes). The
//                                dq kernel walks the key tiles twice — the row
//                                term, then dq — and leaves the row term in
//                                fp32 scratch for the dk/dv kernel. Two
//                                launches, dq first.
// K5 bwd  (kSmallHead = false)          replaced the library flash_attention's
//                                        _flash_attention_bwd_dkv and _dq:
//                                p = exp(s - m) * (1 / l) from the forward's m
//                                and l, the row term di = rowsum(o . do) from
//                                the bf16 o (a torch reduction in the wrapper,
//                                as the library computes it outside its
//                                kernels). Two launches, in either order.
//
// Both then form ds = p * (dp - row term) in fp32, round p and ds * scale to
// bf16, and accumulate dv = p^T . do, dk = ds^T . q (the dk/dv kernel: one
// block per 64-key tile, walking the query tiles at or below the diagonal)
// and dq = ds . k (the dq kernel: one block per 64-query tile, walking the
// key tiles up to the diagonal) in fp32 WMMA accumulators held in registers
// across the walk, written once in bf16. Each kernel recomputes s = q.k^T
// and dp = do.v^T for its tiles, as the library's two kernels do: 7 tile
// matmuls for K5 against the 5 of the function itself, 9 for K4.
//
// Layout: q, k, v, out (and do, dq, dk, dv) [B, H, L, D] bf16, contiguous;
// scale 1/sqrt(D).
//
// What bounds them on an H100: bytes, narrowly, at head dim 64. At the
// serving shape of the sequential template (B 64, H 8, L 512, D 64) the
// causal half of QK^T and PV is 4·B·H·L²·D/2 = 17.2 GFLOP (0.0174 ms at
// 989 TFLOP/s) against 134 MB of q, k, v and out (0.040 ms at 3.35 TB/s):
// 128 operations per byte, under the ~295 where the bf16 tensor cores
// become the limit; at L 1024 68.7 GFLOP against 268 MB, 256 per byte. So
// a kernel near its bound streams q, k, v once and keeps every [L, L] score
// out of device memory — which both designs below do — and also keeps the
// tensor cores busy, which these first versions do not. K4's TPU design —
// a whole [L, L] fp32 score block per head in VMEM — cannot exist here
// (1 MB at L 512 against 227 KB of shared memory a block), so both kernels
// tile queries AND keys:
//
// - one block per (batch row, head, 64-row query tile), 4 warps, each warp
//   owning 16 query rows; heavy tiles (near the end of the sequence) are
//   scheduled first;
// - the Q tile and one 64-key K (and V) tile in shared memory, bf16;
// - q.k^T and p.v on the tensor cores: WMMA bf16 16x16x16 fragments with
//   fp32 accumulators;
// - key tiles strictly above the diagonal are skipped (the causal half of
//   the work), the diagonal tile is masked;
// - softmax on a row is done by 2 lanes of its warp (32 columns each), with
//   the row's fp32 output accumulator in those lanes' registers, so the
//   rescale needs no knowledge of the fragments' opaque layout.
//
// Making them fast (wgmma, TMA, a pipelined producer warp, no score round
// trip through shared memory) is later work; these are the simple, correct
// first versions. Every launch returns cudaGetLastError() and the Python
// wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kTile = 64;                 // query rows and key columns a tile
constexpr int kWarps = 4;                 // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                 // WMMA M

template <int D>
struct Smem {
  // bytes of dynamic shared memory: Q, K, V tiles (bf16), then per warp a
  // fp32 scratch (scores [16, 64], later the PV tile [16, D]) and the bf16
  // p tile [16, 64]
  static constexpr int kScratch = (D > kTile ? D : kTile) * kRows;  // floats
  static constexpr size_t kBytes =
      3 * kTile * D * sizeof(__nv_bfloat16) +
      kWarps * (kScratch * sizeof(float) + kRows * kTile * sizeof(__nv_bfloat16));
};

// copy a [kTile, D] bf16 tile (contiguous in global memory) to shared
// memory, 16 bytes a thread per step
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  constexpr int kVec = kTile * D * 2 / 16;
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < kVec; i += kThreads) d[i] = s[i];
}

// s_w[16, 64] = q_w[16, D] . k_tile[64, D]^T, fp32, into the warp's scratch
template <int D>
__device__ __forceinline__ void warp_scores(float* s_w, const __nv_bfloat16* q_w,
                                            const __nv_bfloat16* k_s) {
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, q_w + kk * 16, D);
      // k^T as a column-major [D, 64] matrix: element (d, key) at key*D + d
      wmma::load_matrix_sync(b, k_s + n * 16 * D + kk * 16, D);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s_w + n * 16, acc, kTile, wmma::mem_row_major);
  }
}

// pv_w[16, D] = p_w[16, 64] . v_tile[64, D], fp32, into the warp's scratch
template <int D>
__device__ __forceinline__ void warp_pv(float* pv_w, const __nv_bfloat16* p_w,
                                        const __nv_bfloat16* v_s) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p_w + kk * 16, kTile);
      wmma::load_matrix_sync(b, v_s + kk * 16 * D + n * 16, D);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(pv_w + n * 16, acc, D, wmma::mem_row_major);
  }
}

// This lane's 32 scores of its row: scaled, and masked on the diagonal tile
// (key column > query row → -inf). Returns their max.
__device__ __forceinline__ float lane_scores(float (&s)[32], const float* s_row,
                                             int half, bool diag, int row,
                                             float scale) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = half * 32 + j;
    float x = s_row[col] * scale;
    if (diag && col > row) x = -INFINITY;
    s[j] = x;
    mx = fmaxf(mx, x);
  }
  return mx;
}

template <int D, bool kTwoPass>
__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kTile * D;
  __nv_bfloat16* v_s = k_s + kTile * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(v_s + kTile * D) +
                   warp * Smem<D>::kScratch;
  __nv_bfloat16* p_w = reinterpret_cast<__nv_bfloat16*>(
                           reinterpret_cast<float*>(v_s + kTile * D) +
                           kWarps * Smem<D>::kScratch) +
                       warp * kRows * kTile;

  const int n_tiles = L / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // heavy tiles first
  const size_t head = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * L * D;
  const __nv_bfloat16* k_head = k + head;
  const __nv_bfloat16* v_head = v + head;

  load_tile<D>(q_s, q + head + (size_t)qt * kTile * D);
  const __nv_bfloat16* q_w = q_s + warp * kRows * D;

  // lane → (row of the warp's 16, half of the columns)
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * kRows + r;  // row within the query tile
  const unsigned full = 0xffffffffu;
  float m = -INFINITY, l = 0.f;
  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float s[32];

  if (kTwoPass) {
    // pass 1: the row's max and sum over every key it sees
    for (int kt = 0; kt <= qt; ++kt) {
      __syncthreads();  // the previous K tile is consumed
      load_tile<D>(k_s, k_head + (size_t)kt * kTile * D);
      __syncthreads();
      warp_scores<D>(scratch, q_w, k_s);
      __syncwarp();
      float mx = lane_scores(s, scratch + r * kTile, half, kt == qt, row, scale);
      mx = fmaxf(mx, __shfl_xor_sync(full, mx, 1));
      const float m_new = fmaxf(m, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sum += expf(s[j] - m_new);
      sum += __shfl_xor_sync(full, sum, 1);
      l = l * expf(m - m_new) + sum;
      m = m_new;
      __syncwarp();  // scratch is read before the next tile overwrites it
    }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<D>(k_s, k_head + (size_t)kt * kTile * D);
    load_tile<D>(v_s, v_head + (size_t)kt * kTile * D);
    __syncthreads();
    warp_scores<D>(scratch, q_w, k_s);
    __syncwarp();
    float mx = lane_scores(s, scratch + r * kTile, half, kt == qt, row, scale);
    float alpha = 1.f;
    if (kTwoPass) {
      // p = exp(s - m) / l, normalised in fp32 before the bf16 rounding
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = expf(s[j] - m) / l;
    } else {
      mx = fmaxf(mx, __shfl_xor_sync(full, mx, 1));
      const float m_new = fmaxf(m, mx);
      alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = expf(s[j] - m_new);
        sum += s[j];
      }
      sum += __shfl_xor_sync(full, sum, 1);
      l = l * alpha + sum;
      m = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j)
      p_w[r * kTile + half * 32 + j] = __float2bfloat16_rn(s[j]);
    __syncwarp();  // p is written and the scores are read
    warp_pv<D>(scratch, p_w, v_s);
    __syncwarp();
    const float* pv_row = scratch + r * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = o[j] * alpha + pv_row[j];
    __syncwarp();  // the PV tile is read before the next scores overwrite it
  }

  __nv_bfloat16* out_row =
      out + head + ((size_t)qt * kTile + row) * D + half * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 2; ++j)
    out_row[j] = __float2bfloat16_rn(kTwoPass ? o[j] : o[j] / l);
  if (m_out != nullptr && half == 0) {  // the backward's residuals
    const size_t stat = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * L +
                        (size_t)qt * kTile + row;
    m_out[stat] = m;
    l_out[stat] = l;
  }
}

template <int D, bool kTwoPass>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* m_out, void* l_out, int B, int H, int L,
                   cudaStream_t stream) {
  auto kernel = causal_attention_kernel<D, kTwoPass>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), L,
      (float)(1.0 / sqrt((double)D)));  // the reference's 1/math.sqrt(d)
  return cudaGetLastError();
}

template <bool kTwoPass>
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* m_out, void* l_out, int B, int H, int L, int D,
             void* stream) {
  if (L % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32, kTwoPass>(q, k, v, out, m_out, l_out, B, H, L, s); break;
    case 64: err = launch<64, kTwoPass>(q, k, v, out, m_out, l_out, B, H, L, s); break;
    case 128: err = launch<128, kTwoPass>(q, k, v, out, m_out, l_out, B, H, L, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// -- backward -----------------------------------------------------------------

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[n] (the warp's [16, D] fp32 sum, D/16 fragments) += A[16, 64] . b[64, D].
// A is bf16 with leading dimension lda: row_major reads A(i, j) at
// a[i * lda + j] (a warp's own ds rows), col_major at a[i + j * lda] (the
// transpose of a block-wide [64 queries, 64 keys] tile: A(key, query)).
// b is a [64, D] bf16 tile in shared memory, row-major.
template <int D, typename ALayout>
__device__ __forceinline__ void warp_mma_acc(Acc (&acc)[D / 16],
                                             const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b_s) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa;
    if constexpr (std::is_same<ALayout, wmma::row_major>::value) {
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
    } else {
      wmma::load_matrix_sync(fa, a + kk * 16 * lda, lda);
    }
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b_s + kk * 16 * D + n * 16, D);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write the warp's [16, D] fp32 sum to dst (16 rows of a [*, D] bf16
// tensor), rounded to bf16, through the warp's fp32 scratch (16 * D floats).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           Acc (&acc)[D / 16], float* scratch,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], D, wmma::mem_row_major);
  __syncwarp();
  const int off = (lane >> 1) * D + (lane & 1) * (D / 2);
#pragma unroll
  for (int j = 0; j < D / 2; ++j)
    dst[off + j] = __float2bfloat16_rn(scratch[off + j]);
  __syncwarp();
}

// p of one score: K4 normalises by a division, the library flash kernel by a
// multiply with the row's reciprocal sum (flash_attention.py:894-899).
template <bool kSmallHead>
__device__ __forceinline__ float prob(float x, float m, float l, float inv_l) {
  return kSmallHead ? expf(x - m) / l : expf(x - m) * inv_l;
}

template <int D>
struct BwdSmem {
  // q, do, k, v tiles (bf16), then per warp the fp32 scores and dp
  // [16, 64] each (later the [16, D] output scratch, D <= 128), then
  // the bf16 ds (dq kernel: per warp [16, 64]) or p and ds (dk/dv kernel:
  // block-wide [64, 64] each) — the same bytes either way
  static constexpr size_t kTiles = 4 * kTile * D * sizeof(__nv_bfloat16);
  static constexpr size_t kScores = kWarps * 2 * kRows * kTile * sizeof(float);
  static constexpr size_t kBytes =
      kTiles + kScores + 2 * kTile * kTile * sizeof(__nv_bfloat16);
  static_assert(2 * kRows * kTile >= kRows * D, "output scratch too small");
};

// One block per (64-query tile, head, batch row), heavy tiles first: dq of
// the tile. Each row's m and l are the forward's (m_rows, l_rows). K4
// (kSmallHead) first computes each row's term rowsum(dp . p) from q, k, v,
// do and stores it in t_rows; K5 reads it there (t = di).
template <int D, bool kSmallHead>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ m_rows,
                        const float* __restrict__ l_rows,
                        float* __restrict__ t_rows,
                        __nv_bfloat16* __restrict__ dq, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kTile * D;
  __nv_bfloat16* k_s = do_s + kTile * D;
  __nv_bfloat16* v_s = k_s + kTile * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_w = reinterpret_cast<float*>(smem + BwdSmem<D>::kTiles) +
               warp * 2 * kRows * kTile;
  float* dp_w = s_w + kRows * kTile;
  __nv_bfloat16* ds_w = reinterpret_cast<__nv_bfloat16*>(
                            smem + BwdSmem<D>::kTiles + BwdSmem<D>::kScores) +
                        warp * kRows * kTile;

  const int n_tiles = L / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // heavy tiles first
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t head = bh * L * D;
  load_tile<D>(q_s, q + head + (size_t)qt * kTile * D);
  load_tile<D>(do_s, dout + head + (size_t)qt * kTile * D);
  const __nv_bfloat16* q_w = q_s + warp * kRows * D;
  const __nv_bfloat16* do_w = do_s + warp * kRows * D;

  const int r = lane >> 1, half = lane & 1;
  const int row = warp * kRows + r;
  const size_t stat = bh * L + (size_t)qt * kTile + row;
  const float m = m_rows[stat], l = l_rows[stat];
  float t;
  float s[32];

  if (kSmallHead) {
    // pass 1: the row term rowsum(dp . p), p and dp in fp32
    t = 0.f;
    for (int kt = 0; kt <= qt; ++kt) {
      __syncthreads();
      load_tile<D>(k_s, k + head + (size_t)kt * kTile * D);
      load_tile<D>(v_s, v + head + (size_t)kt * kTile * D);
      __syncthreads();
      warp_scores<D>(s_w, q_w, k_s);
      warp_scores<D>(dp_w, do_w, v_s);
      __syncwarp();
      lane_scores(s, s_w + r * kTile, half, kt == qt, row, scale);
      const float* dp_row = dp_w + r * kTile + half * 32;
#pragma unroll
      for (int j = 0; j < 32; ++j) t += prob<true>(s[j], m, l, 0.f) * dp_row[j];
      __syncwarp();
    }
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    if (half == 0) t_rows[stat] = t;
  } else {
    t = t_rows[stat];
  }
  const float inv_l = 1.f / l;

  Acc acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<D>(k_s, k + head + (size_t)kt * kTile * D);
    load_tile<D>(v_s, v + head + (size_t)kt * kTile * D);
    __syncthreads();
    warp_scores<D>(s_w, q_w, k_s);
    warp_scores<D>(dp_w, do_w, v_s);
    __syncwarp();
    lane_scores(s, s_w + r * kTile, half, kt == qt, row, scale);
    const float* dp_row = dp_w + r * kTile + half * 32;
    __nv_bfloat16* ds_row = ds_w + r * kTile + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float ds = prob<kSmallHead>(s[j], m, l, inv_l) * (dp_row[j] - t);
      ds_row[j] = __float2bfloat16_rn(ds * scale);
    }
    __syncwarp();
    warp_mma_acc<D, wmma::row_major>(acc, ds_w, kTile, k_s);
    __syncwarp();
  }
  store_rows<D>(dq + head + ((size_t)qt * kTile + warp * kRows) * D, acc, s_w,
                lane);
}

// One block per (64-key tile, head, batch row), heavy tiles (the first)
// first: dk and dv of the tile, walking the query tiles at or below the
// diagonal. Reads each query row's m, l and row term from m_rows, l_rows,
// t_rows.
template <int D, bool kSmallHead>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ m_rows,
                         const float* __restrict__ l_rows,
                         const float* __restrict__ t_rows,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kTile * D;
  __nv_bfloat16* k_s = do_s + kTile * D;
  __nv_bfloat16* v_s = k_s + kTile * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_w = reinterpret_cast<float*>(smem + BwdSmem<D>::kTiles) +
               warp * 2 * kRows * kTile;
  float* dp_w = s_w + kRows * kTile;
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(
      smem + BwdSmem<D>::kTiles + BwdSmem<D>::kScores);  // [64 q, 64 keys]
  __nv_bfloat16* ds_s = p_s + kTile * kTile;             // [64 q, 64 keys]

  const int n_tiles = L / kTile;
  const int kt = blockIdx.x;  // the first key tiles see the most queries
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t head = bh * L * D;
  load_tile<D>(k_s, k + head + (size_t)kt * kTile * D);
  load_tile<D>(v_s, v + head + (size_t)kt * kTile * D);
  const __nv_bfloat16* q_w = q_s + warp * kRows * D;
  const __nv_bfloat16* do_w = do_s + warp * kRows * D;

  const int r = lane >> 1, half = lane & 1;
  const int row = warp * kRows + r;  // query row within the query tile
  float s[32];

  Acc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  for (int qt = kt; qt < n_tiles; ++qt) {
    __syncthreads();  // the previous q, do, p and ds tiles are consumed
    load_tile<D>(q_s, q + head + (size_t)qt * kTile * D);
    load_tile<D>(do_s, dout + head + (size_t)qt * kTile * D);
    __syncthreads();
    warp_scores<D>(s_w, q_w, k_s);
    warp_scores<D>(dp_w, do_w, v_s);
    __syncwarp();
    const size_t stat = bh * L + (size_t)qt * kTile + row;
    const float m = m_rows[stat], l = l_rows[stat], t = t_rows[stat];
    const float inv_l = 1.f / l;
    lane_scores(s, s_w + r * kTile, half, qt == kt, row, scale);
    const float* dp_row = dp_w + r * kTile + half * 32;
    __nv_bfloat16* p_row = p_s + row * kTile + half * 32;
    __nv_bfloat16* ds_row = ds_s + row * kTile + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = prob<kSmallHead>(s[j], m, l, inv_l);
      p_row[j] = __float2bfloat16_rn(p);
      ds_row[j] = __float2bfloat16_rn(p * (dp_row[j] - t) * scale);
    }
    __syncthreads();  // p and ds of all 64 query rows are in place
    // this warp's 16 keys: dv += p^T . do, dk += ds^T . q
    warp_mma_acc<D, wmma::col_major>(dv_acc, p_s + warp * kRows, kTile, do_s);
    warp_mma_acc<D, wmma::col_major>(dk_acc, ds_s + warp * kRows, kTile, q_s);
  }
  const size_t out = head + ((size_t)kt * kTile + warp * kRows) * D;
  store_rows<D>(dv + out, dv_acc, s_w, lane);
  store_rows<D>(dk + out, dk_acc, s_w, lane);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const void *m, *l;   // fp32 [B, H, L], from the forward
  void* t;             // fp32 [B, H, L]: K4's row term (scratch), K5's di
  void *dq, *dk, *dv;  // bf16 [B, H, L, D]; null: not computed by this call
};

template <int D, bool kSmallHead>
cudaError_t launch_bwd(const BwdArgs& a, int B, int H, int L,
                       cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::kBytes;
  const dim3 grid(L / kTile, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  using bf = __nv_bfloat16;
  cudaError_t err = cudaSuccess;
  if (a.dq != nullptr) {  // first: K4's dq kernel writes the row term
    auto kernel = attention_bwd_dq_kernel<D, kSmallHead>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
        static_cast<const float*>(a.m), static_cast<const float*>(a.l),
        static_cast<float*>(a.t), static_cast<bf*>(a.dq), L, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.dk != nullptr) {
    auto kernel = attention_bwd_dkv_kernel<D, kSmallHead>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout),
        static_cast<const float*>(a.m), static_cast<const float*>(a.l),
        static_cast<const float*>(a.t), static_cast<bf*>(a.dk),
        static_cast<bf*>(a.dv), L, scale);
    err = cudaGetLastError();
  }
  return err;
}

template <bool kSmallHead>
int dispatch_bwd(const BwdArgs& a, int B, int H, int L, int D, void* stream) {
  if (L % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_bwd<32, kSmallHead>(a, B, H, L, s); break;
    case 64: err = launch_bwd<64, kSmallHead>(a, B, H, L, s); break;
    case 128: err = launch_bwd<128, kSmallHead>(a, B, H, L, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forwards: m and l are both null (serving) or both fp32 [B, H, L]
int pio_causal_mha_small_head(const void* q, const void* k, const void* v,
                              void* out, void* m, void* l, int B, int H, int L,
                              int D, void* stream) {
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, out, m, l, B, H, L, D, stream);
}

// K4 backward: m, l from the forward; t is fp32 [B, H, L] scratch the dq
// kernel fills
int pio_causal_mha_small_head_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* m,
                                  const void* l, void* t, void* dq, void* dk,
                                  void* dv, int B, int H, int L, int D,
                                  void* stream) {
  if (m == nullptr || l == nullptr || t == nullptr || dq == nullptr ||
      dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_bwd<true>(BwdArgs{q, k, v, dout, m, l, t, dq, dk, dv}, B, H,
                            L, D, stream);
}

}  // extern "C"
