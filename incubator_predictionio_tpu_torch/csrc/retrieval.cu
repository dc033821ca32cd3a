// Retrieval kernels of the serving hot path, written by hand for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// K1  pio_score_catalog    replaces incubator_predictionio_tpu/ops/retrieval.py
//                          score_catalog_quantized (Pallas _score_kernel and
//                          _score_kernel_rowmask):
//        scores[b, n] = (bf16(q[b]) . float(items_q[n])) * scale[n] + bias[n]
//                       + mask[n] (+ row_mask[b, n])
// K2  pio_score_centroids  replaces score_centroids_quantized (Pallas
//                          _coarse_kernel), the int8 IVF coarse probe:
//        scores[b, c] = float(int32 sum_d q_q[b, d] * cent_q[c, d])
//                       * (q_scale[b] * cent_scale[c]) + cent_bias[c]
//
// What bounds K1 on an H100: the fp32 score store. At the serving shape
// (B 64, N 1,000,448, D 32) it writes 256 MB of scores and reads a 32 MB int8
// catalog for 4 GFLOP, about 14 operations a byte, twenty times below the
// ~295 where the bf16 tensor cores and not HBM set the pace. So the design
// keeps the products and the epilogue off the store's critical path:
// - products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums):
//   int8 -> bf16 is exact (|x| <= 127 has 7 significant bits) and bf16 x bf16
//   products are exact in fp32, so the scores differ from the plain PyTorch
//   version only in the order of the fp32 sums. Items sit on M, queries on N.
//   The K order inside each 16-dim step is permuted (the same for both
//   operands, which leaves the dot product as it is) so that a thread's
//   slice of a catalog row is 4 * steps contiguous bytes, and the queries'
//   fragments sit in shared memory in the same order, one 8-byte load a
//   step for each 8 queries;
// - one catalog pass per launch: a block stages the batch's bf16 query
//   fragments once (up to 64 KB: every B <= 128 at every D <= 256; a larger
//   batch takes a launch a chunk) and walks 128-item tiles blockIdx.x,
//   + gridDim.x, ... (as many blocks as the card holds at once), so each
//   catalog row, scale, bias and mask is read once. The tiles arrive by
//   cp.async in a ring of slots in shared memory, two ahead of the tile
//   whose products and stores run (one past D 128);
// - a staged store epilogue (B > 8): the epilogue runs in registers on the
//   accumulators, in the reference's order with __fmul_rn / __fadd_rn (no FMA
//   contraction), into a [64 queries][128 + 4 items] fp32 tile in shared
//   memory (the padding makes the transpose conflict-free); each warp then
//   writes whole 512-byte runs of output rows with 16-byte streaming stores
//   (__stcs: 256 MB passes the 50 MB L2 once). The row-mask variant reads
//   its [B, tile] block with 16-byte loads in the same layout.
// For B <= 8 the catalog, not the store, is most of the bytes and a tile's
// work is short, so a second kernel (score_catalog_kernel_b8) runs one block
// a tile with no ring and no staging: each thread's rows load straight into
// registers, each warp takes two 16-row slices, and the accumulators go
// straight out (each store instruction writes whole 32-byte sectors).
// A D that is not a multiple of 16 pads K with zeros in registers (zero
// products add exactly 0).
//
// K2 is small (C = 1024 centroids at 1M items, B 64: 64 K dot products of
// 32 bytes, 0.3 MB of traffic), so at the probe's sizes a launch's fixed cost
// and the latency of its memory round trips bound it, not HBM. The design
// keeps one round trip a thread and fills the card: a thread scores one
// centroid row against Q queries and issues every load before its first
// product (the row and the queries as 16-byte loads, the scales and the bias
// beside them; no shared memory and no barrier); blocks of 64 rows and Q of
// 2 queries up to B 128 (B 64: 512 blocks on 132 SMs), 4 above. The dot
// products run with __dp4a on 4 int8 lanes into an exact int32 accumulator;
// the epilogue is written with __fmul_rn / __fadd_rn so no FMA contraction
// moves the last bit: the scores equal the host probe math
// (int8_matmul_exact, then the rescale and the bias) bit for bit, and so do
// the probe sets.
//
// Every launch returns cudaGetLastError() and the Python wrapper raises when
// it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <utility>

#include "attention_sm90.cuh"  // smem_addr, cp_async16, cp_async_commit, pack_bf16

namespace {

// -- K1 -----------------------------------------------------------------------

constexpr int kItemTile = 128;                // catalog rows a block tile
constexpr int kWarps = kItemTile / 16;        // one 16-row slice a warp
constexpr int kCatalogThreads = 32 * kWarps;  // 256
constexpr int kSmallThreads = kCatalogThreads / 2;  // B <= 8: two slices a warp
constexpr int kQueryTile = 64;                // queries a staged store pass
constexpr int kStageStride = kItemTile + 4;   // floats a staging row
constexpr int kMaxSteps = 16;                 // 16-dim K steps: D <= 256
constexpr int kQueryBytes = 64 * 1024;        // bf16 query fragments a pass

// tiles in the shared-memory ring: two ahead of the one in use, one where a
// tile's slot is large
template <int S>
struct Ring {
  static constexpr int kStages = S <= 8 ? 3 : 2;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The four int8 lanes of w as two bf16x2 (lanes 0, 1 -> lo; 2, 3 -> hi),
// exactly: an integer with |x| <= 128 has at most 8 significant bits, so
// the low 16 bits of its fp32 are zero and the top 16 are its bf16; one
// byte permute packs two.
__device__ __forceinline__ void i8x4_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(static_cast<float>(static_cast<int8_t>(w >> (8 * i))));
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The bf16 query fragments of B queries, [S][Bp][4 threads of a quad] x 4
// bf16 (Bp: B rounded up to 8, zeros past B and past D): the B fragments of
// K step s for query b and quad thread t hold dims t*4S + 4s + {0, 1 | 2, 3}.
template <int S>
__device__ __forceinline__ void stage_queries(uint2* qs, const float* __restrict__ q,
                                              int B, int Bp, int D) {
  for (int i = threadIdx.x; i < S * Bp * 4; i += blockDim.x) {
    const int t = i & 3, b = (i >> 2) % Bp, s = (i >> 2) / Bp;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = t * 4 * S + 4 * s + j;
      v[j] = (b < B && d < D) ? q[(size_t)b * D + d] : 0.f;
    }
    qs[i] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// One tile's slot of the ring: its 128 catalog rows as they lie in device
// memory ([128][D] bytes: a multiple of 16 at every D), then its scale,
// bias and mask ([3][128] fp32), in 16-byte chunks: cp.async, or a plain
// copy where a base pointer is not 16-byte aligned. vec is this thread's
// chunk of the three vectors (threads 0..95), relative to the tile's first
// item; null for the other threads.
__device__ __forceinline__ void copy_tile(unsigned char* slot,
                                          const int8_t* __restrict__ items,
                                          const float* vec, int n0, int D,
                                          bool async) {
  const int rows = 8 * D;  // 16-byte chunks of the catalog rows
  const unsigned char* cat =
      reinterpret_cast<const unsigned char*>(items) + (size_t)n0 * D;
  auto copy16 = [&](unsigned char* dst, const void* src) {
    if (async) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) dst[b] = static_cast<const unsigned char*>(src)[b];
    }
  };
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    copy16(slot + 16 * i, cat + 16 * i);
  if (vec != nullptr) copy16(slot + 16 * (rows + threadIdx.x), vec + n0);
}

// This thread's slice of one catalog row (in a slot, or in device memory):
// bytes t*4S + [0, 4S), as S words (word s holds K step s), zeros past D.
// aligned: the row's base is 16-byte aligned where D % 16 == 0 and 4-byte
// aligned where D % 4 == 0; otherwise it loads bytewise.
template <int S>
__device__ __forceinline__ void row_words(uint32_t (&w)[S], const unsigned char* row,
                                          int D, int t, bool aligned) {
  const unsigned char* p = row + t * 4 * S;
  if (aligned && (D & 15) == 0) {  // D == 16 S: the widest load the slice allows
    if constexpr (S % 4 == 0) {
#pragma unroll
      for (int i = 0; i < S / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
      }
    } else if constexpr (S % 2 == 0) {
#pragma unroll
      for (int i = 0; i < S / 2; ++i) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[i];
        w[2 * i] = v.x; w[2 * i + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < S; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    }
  } else if (aligned && (D & 3) == 0) {  // whole words, each below D or past it
#pragma unroll
    for (int i = 0; i < S; ++i)
      w[i] = t * 4 * S + 4 * i < D ? reinterpret_cast<const uint32_t*>(p)[i] : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t * 4 * S + 4 * i + j < D) v |= static_cast<uint32_t>(p[4 * i + j]) << (8 * j);
      w[i] = v;
    }
  }
}

// the reference's order: ((s * scale + bias) + mask), each step rounded
__device__ __forceinline__ float epilogue(float acc, float s, float b, float m) {
  return __fadd_rn(__fadd_rn(__fmul_rn(acc, s), b), m);
}

// B > 8. S: K steps of 16 dims (D <= 16 S). B: the queries of this launch,
// all staged. N % kItemTile == 0. Each block walks item tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., Ring<S>::kStages - 1 of them in flight ahead
// of the one whose products and stores run.
template <int S, bool kRowMask>
__global__ void __launch_bounds__(kCatalogThreads)
score_catalog_kernel(const float* __restrict__ q,
                     const int8_t* __restrict__ items,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ row_mask,
                     float* __restrict__ out, int B, int N, int D) {
  constexpr int kStages = Ring<S>::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Bp = (B + 7) & ~7;
  const int slot_bytes = kItemTile * D + 3 * kItemTile * 4;
  // [min(64, Bp)][kStageStride] fp32 | kStages slots | query fragments
  float* stage = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + sizeof(float) * min(kQueryTile, Bp) * kStageStride;
  uint2* qs = reinterpret_cast<uint2*>(ring + kStages * slot_bytes);
  stage_queries<S>(qs, q, B, Bp, D);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = warp * 16 + g;  // this thread's rows of a tile: col, col + 8
  const int tiles = N / kItemTile;
  const bool async = ((reinterpret_cast<uintptr_t>(items) | reinterpret_cast<uintptr_t>(scale)
                       | reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(mask))
                      & 15) == 0;
  const bool rm16 = kRowMask && (reinterpret_cast<uintptr_t>(row_mask) & 15) == 0;
  const int which = threadIdx.x >> 5;  // scale, bias, mask: 32 chunks each
  const float* vec = threadIdx.x >= 3 * kItemTile / 4
                         ? nullptr
                         : (which == 0 ? scale : which == 1 ? bias : mask) + 4 * lane;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile < tiles)
      copy_tile(ring + i * slot_bytes, items, vec, tile * kItemTile, D, async);
    cp_async_commit();
  }
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int n0 = tile * kItemTile;
    cp_async_wait<kStages - 2>();
    // tile k's slot (and, first, the query fragments) in; every thread is
    // done with tile k - 1's slot, which now takes tile k + kStages - 1
    __syncthreads();
    const int ahead = tile + (kStages - 1) * gridDim.x;
    if (ahead < tiles)
      copy_tile(ring + ((k + kStages - 1) % kStages) * slot_bytes, items, vec,
                ahead * kItemTile, D, async);
    cp_async_commit();
    const unsigned char* slot = ring + (k % kStages) * slot_bytes;
    const float* sbm = reinterpret_cast<const float*>(slot + kItemTile * D);
    const float s0 = sbm[col], b0 = sbm[kItemTile + col], m0 = sbm[2 * kItemTile + col];
    const float s1 = sbm[col + 8], b1 = sbm[kItemTile + col + 8],
                m1 = sbm[2 * kItemTile + col + 8];
    uint32_t w0[S], w1[S];
    row_words<S>(w0, slot + col * D, D, t, true);
    row_words<S>(w1, slot + (col + 8) * D, D, t, true);
    for (int q0 = 0; q0 < B; q0 += kQueryTile) {
      const int nq = min(kQueryTile, B - q0);
      const int nj = (nq + 7) >> 3;  // 8-query column blocks of this pass
      float acc[kQueryTile / 8][4];
#pragma unroll
      for (int j = 0; j < kQueryTile / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        uint32_t a0, a1, a2, a3;  // rows g | g + 8, dims {0, 1} | {2, 3} of the step
        i8x4_bf16x2(w0[s], a0, a2);
        i8x4_bf16x2(w1[s], a1, a3);
        const uint2* qf = qs + ((size_t)s * Bp + q0 + g) * 4 + t;
#pragma unroll
        for (int j = 0; j < kQueryTile / 8; ++j) {
          if (j < nj) {
            const uint2 b = qf[j * 32];
            mma_bf16_16816(acc[j], a0, a1, a2, a3, b.x, b.y);
          }
        }
      }
      // accumulator (item g | g + 8, query 2t | 2t + 1) -> stage[query][item]
#pragma unroll
      for (int j = 0; j < kQueryTile / 8; ++j) {
        if (j < nj) {
          float* r0 = stage + (8 * j + 2 * t) * kStageStride + col;
          r0[0] = epilogue(acc[j][0], s0, b0, m0);
          r0[kStageStride] = epilogue(acc[j][1], s0, b0, m0);
          r0[8] = epilogue(acc[j][2], s1, b1, m1);
          r0[kStageStride + 8] = epilogue(acc[j][3], s1, b1, m1);
        }
      }
      __syncthreads();
      // each warp writes whole output rows of the tile: 32 lanes x 16 bytes
#pragma unroll
      for (int i = 0; i < kQueryTile / kWarps; ++i) {
        const int r = warp + i * kWarps;
        if (r < nq) {
          float4 v = *reinterpret_cast<const float4*>(stage + r * kStageStride + 4 * lane);
          const size_t o = (size_t)(q0 + r) * N + n0 + 4 * lane;
          if constexpr (kRowMask) {
            const float4 m = rm16 ? __ldcs(reinterpret_cast<const float4*>(row_mask + o))
                                  : make_float4(row_mask[o], row_mask[o + 1],
                                                row_mask[o + 2], row_mask[o + 3]);
            v.x = __fadd_rn(v.x, m.x);
            v.y = __fadd_rn(v.y, m.y);
            v.z = __fadd_rn(v.z, m.z);
            v.w = __fadd_rn(v.w, m.w);
          }
          __stcs(reinterpret_cast<float4*>(out + o), v);
        }
      }
      // the next pass's staging writes wait for these reads (the next
      // tile's wait at its first barrier)
      if (q0 + kQueryTile < B) __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// B <= 8: the catalog, not the store, is most of the bytes, and the tile's
// work is short. One block a tile, as many as the card holds: each thread's
// rows load straight into registers while the query fragments stage, each
// warp takes two 16-row slices, and the accumulators go straight to the
// output (each store instruction writes whole 32-byte sectors).
template <int S, bool kRowMask>
__global__ void __launch_bounds__(kSmallThreads)
score_catalog_kernel_b8(const float* __restrict__ q,
                        const int8_t* __restrict__ items,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        const float* __restrict__ row_mask,
                        float* __restrict__ out, int B, int N, int D) {
  constexpr int M = 2;  // 16-row slices a warp
  __shared__ uint2 qs[S * 8 * 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kItemTile;
  const bool aligned = (reinterpret_cast<uintptr_t>(items) & 15) == 0;
  // this thread's rows: col[m] and col[m] + 8 of slice m, their words,
  // scale, bias and mask, and the row mask of its outputs
  // out[dst[m] + (c & 1) N + (c & 2) 4] (item g + 4 (c & 2), query 2t + (c & 1))
  uint32_t w[M][2][S];
  float e[M][2][3], rmv[M][4];
  size_t dst[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int col = n0 + (warp * M + m) * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = col + 8 * h;
      row_words<S>(w[m][h], reinterpret_cast<const unsigned char*>(items) + (size_t)r * D,
                   D, t, aligned);
      e[m][h][0] = __ldg(scale + r);
      e[m][h][1] = __ldg(bias + r);
      e[m][h][2] = __ldg(mask + r);
    }
    dst[m] = (size_t)(2 * t) * N + col;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (kRowMask && 2 * t + (c & 1) < B)
        rmv[m][c] = __ldcs(row_mask + dst[m] + (c & 1) * (size_t)N + (c & 2) * 4);
  }
  stage_queries<S>(qs, q, B, 8, D);
  __syncthreads();
  float acc[M][4] = {};
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint2 b = qs[(s * 8 + g) * 4 + t];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      uint32_t a0, a1, a2, a3;  // rows g | g + 8, dims {0, 1} | {2, 3} of the step
      i8x4_bf16x2(w[m][0][s], a0, a2);
      i8x4_bf16x2(w[m][1][s], a1, a3);
      mma_bf16_16816(acc[m], a0, a1, a2, a3, b.x, b.y);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (2 * t + (c & 1) < B) {
        const int h = c >> 1;
        float v = epilogue(acc[m][c], e[m][h][0], e[m][h][1], e[m][h][2]);
        if constexpr (kRowMask) v = __fadd_rn(v, rmv[m][c]);
        __stcs(out + dst[m] + (c & 1) * (size_t)N + (c & 2) * 4, v);
      }
    }
  }
}

template <int S, bool kRowMask>
cudaError_t launch_score_catalog(const float* q, const int8_t* items,
                                 const float* scale, const float* bias,
                                 const float* mask, const float* row_mask,
                                 float* out, int B, int N, int D, int sms,
                                 cudaStream_t stream) {
  if (B <= 8) {
    score_catalog_kernel_b8<S, kRowMask><<<N / kItemTile, kSmallThreads, 0, stream>>>(
        q, items, scale, bias, mask, row_mask, out, B, N, D);
    return cudaGetLastError();
  }
  auto kernel = score_catalog_kernel<S, kRowMask>;
  const int Bp = (B + 7) & ~7;
  const size_t smem = sizeof(float) * std::min(kQueryTile, Bp) * kStageStride
                      + (size_t)Ring<S>::kStages * (kItemTile * D + 3 * kItemTile * 4)
                      + (size_t)32 * S * Bp;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kCatalogThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  kernel<<<std::min(N / kItemTile, per_sm * sms), kCatalogThreads, smem, stream>>>(
      q, items, scale, bias, mask, row_mask, out, B, N, D);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_steps(const float* q, const int8_t* items, const float* scale,
                         const float* bias, const float* mask,
                         const float* row_mask, float* out, int B, int N, int D,
                         cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // queries a launch: their fragments (32 S bytes each) fit kQueryBytes, so
  // every B <= 128 is one pass over the catalog at every D <= 256
  const int chunk = (kQueryBytes / (32 * S)) & ~7;
  for (int b0 = 0; b0 < B && err == cudaSuccess; b0 += chunk) {
    const int nb = std::min(chunk, B - b0);
    const float* rm = row_mask == nullptr ? nullptr : row_mask + (size_t)b0 * N;
    err = rm != nullptr
              ? launch_score_catalog<S, true>(q + (size_t)b0 * D, items, scale, bias, mask,
                                              rm, out + (size_t)b0 * N, nb, N, D, sms, stream)
              : launch_score_catalog<S, false>(q + (size_t)b0 * D, items, scale, bias, mask,
                                               rm, out + (size_t)b0 * N, nb, N, D, sms, stream);
  }
  return err;
}

using CatalogLauncher = cudaError_t (*)(const float*, const int8_t*,
                                        const float*, const float*,
                                        const float*, const float*, float*,
                                        int, int, int, cudaStream_t);

template <int... I>
constexpr auto catalog_launchers(std::integer_sequence<int, I...>) {
  return std::array<CatalogLauncher, sizeof...(I)>{&launch_steps<I + 1>...};
}

// -- K2 -----------------------------------------------------------------------

constexpr int kCentThreads = 64;  // centroid rows a block, one a thread
constexpr int kCentChunks = 2;    // 16-byte chunks of a row a pass: D 32 in one

// One thread scores one centroid row against the block's Q queries. Every
// global load of a pass is issued before its arithmetic: the row's scale
// and bias, the Q query scales, then the row and the Q query rows as 16-byte
// loads (the queries are the same addresses across the block: one
// broadcast). At D <= 32 a thread makes one memory round trip, then
// 4 Q kCentChunks __dp4a, then Q stores. kVec16: D % 16 == 0 and both int8
// tables 16-byte aligned; otherwise a bytewise loop (exact all the same).
template <int Q, bool kVec16>
__global__ void __launch_bounds__(kCentThreads)
score_centroids_kernel(const int8_t* __restrict__ q_q,
                       const float* __restrict__ q_scales,
                       const int8_t* __restrict__ cent_q,
                       const float* __restrict__ cent_scales,
                       const float* __restrict__ cent_bias,
                       float* __restrict__ out, int B, int C, int D) {
  const int c = blockIdx.x * kCentThreads + threadIdx.x;
  const int b0 = blockIdx.y * Q;
  if (c >= C) return;
  const float cs = __ldg(cent_scales + c), cb = __ldg(cent_bias + c);
  float qs[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) qs[j] = b0 + j < B ? __ldg(q_scales + b0 + j) : 0.f;
  int acc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) acc[j] = 0;
  if constexpr (kVec16) {
    const int chunks = D >> 4;
    const uint4* row = reinterpret_cast<const uint4*>(cent_q + (size_t)c * D);
    const uint4* qrow = reinterpret_cast<const uint4*>(q_q + (size_t)b0 * D);
    for (int k0 = 0; k0 < chunks; k0 += kCentChunks) {
      uint4 x[kCentChunks], y[Q][kCentChunks];
#pragma unroll
      for (int k = 0; k < kCentChunks; ++k) {
        const bool in = k0 + k < chunks;
        x[k] = in ? __ldg(row + k0 + k) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < Q; ++j)
          y[j][k] = in && b0 + j < B ? __ldg(qrow + j * chunks + k0 + k)
                                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kCentChunks; ++k)
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          acc[j] = __dp4a((int)x[k].x, (int)y[j][k].x, acc[j]);
          acc[j] = __dp4a((int)x[k].y, (int)y[j][k].y, acc[j]);
          acc[j] = __dp4a((int)x[k].z, (int)y[j][k].z, acc[j]);
          acc[j] = __dp4a((int)x[k].w, (int)y[j][k].w, acc[j]);
        }
    }
  } else {
    const int8_t* row = cent_q + (size_t)c * D;
    for (int d = 0; d < D; ++d) {
      const int x = row[d];
#pragma unroll
      for (int j = 0; j < Q; ++j)
        if (b0 + j < B) acc[j] += x * (int)q_q[(size_t)(b0 + j) * D + d];
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (b0 + j >= B) break;
    // acc * (q_scale * c_scale) + c_bias, each step rounded on its own
    out[(size_t)(b0 + j) * C + c] = __fadd_rn(
        __fmul_rn(__int2float_rn(acc[j]), __fmul_rn(qs[j], cs)), cb);
  }
}

template <int Q, bool kVec16>
cudaError_t launch_centroids(const int8_t* q_q, const float* q_scales,
                             const int8_t* cent_q, const float* cent_scales,
                             const float* cent_bias, float* out, int B, int C,
                             int D, cudaStream_t stream) {
  const dim3 grid((C + kCentThreads - 1) / kCentThreads, (B + Q - 1) / Q);
  score_centroids_kernel<Q, kVec16><<<grid, kCentThreads, 0, stream>>>(
      q_q, q_scales, cent_q, cent_scales, cent_bias, out, B, C, D);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_centroid_tiles(const int8_t* q_q, const float* q_scales,
                             const int8_t* cent_q, const float* cent_scales,
                             const float* cent_bias, float* out, int B, int C,
                             int D, cudaStream_t stream) {
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(q_q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cent_q) % 16 == 0;
  return vec16 ? launch_centroids<Q, true>(q_q, q_scales, cent_q, cent_scales,
                                           cent_bias, out, B, C, D, stream)
               : launch_centroids<Q, false>(q_q, q_scales, cent_q, cent_scales,
                                            cent_bias, out, B, C, D, stream);
}

}  // namespace

extern "C" {

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pio_score_catalog(const void* q, const void* items, const void* scale,
                      const void* bias, const void* mask,
                      const void* row_mask, void* out, int B, int N, int D,
                      void* stream) {
  // one instantiation a number of 16-dim K steps
  static constexpr auto launchers =
      catalog_launchers(std::make_integer_sequence<int, kMaxSteps>{});
  if (D < 1 || D > 16 * kMaxSteps || N % kItemTile != 0 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launchers[(D + 15) / 16 - 1](
      static_cast<const float*>(q), static_cast<const int8_t*>(items),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(row_mask),
      static_cast<float*>(out), B, N, D, static_cast<cudaStream_t>(stream)));
}

int pio_score_centroids(const void* q_q, const void* q_scales,
                        const void* cent_q, const void* cent_scales,
                        const void* cent_bias, void* out, int B, int C, int D,
                        void* stream) {
  if (B < 0 || C < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const auto* a = static_cast<const int8_t*>(q_q);
  const auto* qs = static_cast<const float*>(q_scales);
  const auto* cq = static_cast<const int8_t*>(cent_q);
  const auto* cs = static_cast<const float*>(cent_scales);
  const auto* cb = static_cast<const float*>(cent_bias);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // queries a block, chosen on the card at C 1024, D 32 against 1, 4 and 8
  // at every probe bucket: 2 up to B 128 (B 64: 512 blocks), 4 above
  const cudaError_t err =
      B <= 128 ? launch_centroid_tiles<2>(a, qs, cq, cs, cb, o, B, C, D, st)
               : launch_centroid_tiles<4>(a, qs, cq, cs, cb, o, B, C, D, st);
  return static_cast<int>(err);
}

}  // extern "C"
