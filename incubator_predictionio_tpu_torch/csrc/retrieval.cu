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
// What bounds them on an H100: bytes. K1 at the serving shape (B = 64,
// N = 1,000,448, D = 32) writes a 256 MB fp32 score matrix and reads a 32 MB
// int8 catalog for 4 GFLOP: about 14 operations per byte, twenty times below
// the ~295 operations per byte where the bf16 tensor cores, not HBM, become
// the limit. So the design spends nothing on tensor cores: one thread owns
// one catalog row, upcasts it from int8 (exact in fp32) in registers, and
// runs fp32 FMAs against a tile of bf16-rounded queries that the block keeps
// in shared memory (every thread reads the same query word: a broadcast).
// Neighbouring threads own neighbouring rows, so each warp stores 32
// consecutive scores of a query row (coalesced 128-byte stores) — the
// [B, N] output is the traffic that matters. bf16 x int8 products are exact
// in fp32 (8 + 7 significant bits), so the sum differs from the plain
// PyTorch version only in summation order (fp32 roundoff).
//
// K2 is small (C = 1024 centroids at 1M items). Its dot products run with
// __dp4a on 4 int8 lanes into an exact int32 accumulator; the epilogue is
// written with __fmul_rn / __fadd_rn so no FMA contraction moves the last
// bit: the scores equal the host probe math (int8_matmul_exact, then the
// rescale and the bias) bit for bit, and so do the probe sets.
//
// Making these fast (wgmma, TMA, top-k fused into the scorer) is later work;
// these are the simple, correct first versions. Every launch returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // catalog rows per block (one per thread)

template <int BT, bool kRowMask>
__global__ void __launch_bounds__(kThreads)
score_catalog_kernel(const float* __restrict__ q,
                     const int8_t* __restrict__ items,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ row_mask,
                     float* __restrict__ out, int B, int N, int D) {
  // [BT, D] query tile, rounded to bf16 (round to nearest even, as
  // astype(bfloat16) does) and held as fp32
  extern __shared__ float q_s[];
  const int b0 = blockIdx.y * BT;
  for (int i = threadIdx.x; i < BT * D; i += blockDim.x) {
    const int bt = i / D;
    const int b = b0 + bt;
    const float v = (b < B) ? q[(size_t)b * D + (i - bt * D)] : 0.f;
    q_s[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  float acc[BT];
#pragma unroll
  for (int bt = 0; bt < BT; ++bt) acc[bt] = 0.f;
  const int8_t* row = items + (size_t)n * D;
  if ((D & 15) == 0) {
    // 16 int8 lanes per load (the wrapper checks 16-byte alignment)
    for (int d = 0; d < D; d += 16) {
      const int4 w = *reinterpret_cast<const int4*>(row + d);
      const int8_t* p = reinterpret_cast<const int8_t*>(&w);
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = (float)p[j];
#pragma unroll
      for (int bt = 0; bt < BT; ++bt) {
        const float* qr = q_s + bt * D + d;
        float a = acc[bt];
#pragma unroll
        for (int j = 0; j < 16; ++j) a = fmaf(qr[j], x[j], a);
        acc[bt] = a;
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const float x = (float)row[d];
#pragma unroll
      for (int bt = 0; bt < BT; ++bt) acc[bt] = fmaf(q_s[bt * D + d], x, acc[bt]);
    }
  }
  // epilogue in the reference's order: ((s * scale + bias) + mask) + row_mask
  const float s = scale[n], bi = bias[n], m = mask[n];
#pragma unroll
  for (int bt = 0; bt < BT; ++bt) {
    const int b = b0 + bt;
    if (b >= B) break;
    float v = __fadd_rn(__fadd_rn(__fmul_rn(acc[bt], s), bi), m);
    if (kRowMask) v = __fadd_rn(v, row_mask[(size_t)b * N + n]);
    out[(size_t)b * N + n] = v;
  }
}

template <int BT>
cudaError_t launch_score_catalog(const float* q, const int8_t* items,
                                 const float* scale, const float* bias,
                                 const float* mask, const float* row_mask,
                                 float* out, int B, int N, int D,
                                 cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, (B + BT - 1) / BT);
  const size_t smem = (size_t)BT * D * sizeof(float);
  if (row_mask != nullptr) {
    score_catalog_kernel<BT, true><<<grid, kThreads, smem, stream>>>(
        q, items, scale, bias, mask, row_mask, out, B, N, D);
  } else {
    score_catalog_kernel<BT, false><<<grid, kThreads, smem, stream>>>(
        q, items, scale, bias, mask, nullptr, out, B, N, D);
  }
  return cudaGetLastError();
}

constexpr int kCentroidTile = 8;  // queries per block; probe batches are 8·2^k

__global__ void __launch_bounds__(kThreads)
score_centroids_kernel(const int8_t* __restrict__ q_q,
                       const float* __restrict__ q_scales,
                       const int8_t* __restrict__ cent_q,
                       const float* __restrict__ cent_scales,
                       const float* __restrict__ cent_bias,
                       float* __restrict__ out, int B, int C, int D) {
  extern __shared__ __align__(16) int8_t qq_s[];  // [kCentroidTile, D] int8
  const int b0 = blockIdx.y * kCentroidTile;
  for (int i = threadIdx.x; i < kCentroidTile * D; i += blockDim.x) {
    const int b = b0 + i / D;
    qq_s[i] = (b < B) ? q_q[(size_t)b0 * D + i] : (int8_t)0;
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  int acc[kCentroidTile];
#pragma unroll
  for (int bt = 0; bt < kCentroidTile; ++bt) acc[bt] = 0;
  const int8_t* row = cent_q + (size_t)c * D;
  if ((D & 3) == 0) {
    const int* row4 = reinterpret_cast<const int*>(row);
    const int* q4 = reinterpret_cast<const int*>(qq_s);
    const int D4 = D >> 2;
    for (int w = 0; w < D4; ++w) {
      const int x = row4[w];
#pragma unroll
      for (int bt = 0; bt < kCentroidTile; ++bt)
        acc[bt] = __dp4a(x, q4[bt * D4 + w], acc[bt]);
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const int x = row[d];
#pragma unroll
      for (int bt = 0; bt < kCentroidTile; ++bt)
        acc[bt] += x * (int)qq_s[bt * D + d];
    }
  }
  const float cs = cent_scales[c], cb = cent_bias[c];
#pragma unroll
  for (int bt = 0; bt < kCentroidTile; ++bt) {
    const int b = b0 + bt;
    if (b >= B) break;
    // acc * (q_scale * c_scale) + c_bias, each step rounded on its own
    out[(size_t)b * C + c] = __fadd_rn(
        __fmul_rn(__int2float_rn(acc[bt]), __fmul_rn(q_scales[b], cs)), cb);
  }
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
  const float* qf = static_cast<const float*>(q);
  const int8_t* it = static_cast<const int8_t*>(items);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* mk = static_cast<const float*>(mask);
  const float* rm = static_cast<const float*>(row_mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the query tile follows the batch so small batches waste no FMAs
  cudaError_t err;
  if (B <= 1) err = launch_score_catalog<1>(qf, it, sc, bi, mk, rm, o, B, N, D, s);
  else if (B <= 2) err = launch_score_catalog<2>(qf, it, sc, bi, mk, rm, o, B, N, D, s);
  else if (B <= 4) err = launch_score_catalog<4>(qf, it, sc, bi, mk, rm, o, B, N, D, s);
  else if (B <= 8) err = launch_score_catalog<8>(qf, it, sc, bi, mk, rm, o, B, N, D, s);
  else if (B <= 16) err = launch_score_catalog<16>(qf, it, sc, bi, mk, rm, o, B, N, D, s);
  else err = launch_score_catalog<32>(qf, it, sc, bi, mk, rm, o, B, N, D, s);
  return static_cast<int>(err);
}

int pio_score_centroids(const void* q_q, const void* q_scales,
                        const void* cent_q, const void* cent_scales,
                        const void* cent_bias, void* out, int B, int C, int D,
                        void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads,
                  (B + kCentroidTile - 1) / kCentroidTile);
  const size_t smem = (size_t)kCentroidTile * D;
  score_centroids_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q_q), static_cast<const float*>(q_scales),
      static_cast<const int8_t*>(cent_q),
      static_cast<const float*>(cent_scales),
      static_cast<const float*>(cent_bias), static_cast<float*>(out), B, C,
      D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
