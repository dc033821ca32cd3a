// Causal multi-head attention of the sequential recommender, written by hand
// for Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// One templated forward kernel, two instantiations, one per TPU kernel:
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
// K5  pio_flash_causal           replaces the library Pallas flash_attention
//                                that incubator_predictionio_tpu/parallel/
//                                ring.py causal_attention calls for long
//                                sequences: one pass of online softmax, a
//                                running max and sum, the fp32 accumulator
//                                rescaled by exp(m_old - m_new), p rounded to
//                                bf16 before PV, one division by l at the end.
//
// Layout: q, k, v, out [B, H, L, D] bf16, contiguous; scale 1/sqrt(D).
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
                        __nv_bfloat16* __restrict__ out, int L, float scale) {
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
}

template <int D, bool kTwoPass>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int L, cudaStream_t stream) {
  auto kernel = causal_attention_kernel<D, kTwoPass>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), L,
      (float)(1.0 / sqrt((double)D)));  // the reference's 1/math.sqrt(d)
  return cudaGetLastError();
}

template <bool kTwoPass>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int L, int D, void* stream) {
  if (L % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32, kTwoPass>(q, k, v, out, B, H, L, s); break;
    case 64: err = launch<64, kTwoPass>(q, k, v, out, B, H, L, s); break;
    case 128: err = launch<128, kTwoPass>(q, k, v, out, B, H, L, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pio_causal_mha_small_head(const void* q, const void* k, const void* v,
                              void* out, int B, int H, int L, int D,
                              void* stream) {
  return dispatch<true>(q, k, v, out, B, H, L, D, stream);
}

int pio_flash_causal(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int L, int D, void* stream) {
  return dispatch<false>(q, k, v, out, B, H, L, D, stream);
}

}  // extern "C"
