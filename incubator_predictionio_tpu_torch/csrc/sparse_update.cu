// Row-block adam of the streaming fold, written by hand for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes).
//
// K3  pio_adam_rows / pio_adam_rows_indexed  replace
//                    incubator_predictionio_tpu/ops/sparse_update.py
//                    _pallas_adam_rows (the Pallas _adam_rows_kernel) and its
//                    table-resident use fused_gather_adam_scatter: one adam
//                    step over touched rows, each row with its own bias
//                    corrections:
//        m'   = b1 m + (1 - b1) g
//        v'   = b2 v + (1 - b2) (g g)
//        row' = row - lr (m' / bc1[r]) / (sqrt(v' / bc2[r]) + eps)
//
// Two entries, one kernel body:
// - stacked (pio_adam_rows): ``in`` is one [4, R, D] fp32 block (rows, m, v,
//   g) and ``bc`` one [2, R] block (bc1, bc2), so the device engine uploads a
//   micro-batch with one copy; ``out`` is [3, R, D] (rows, m, v), downloaded
//   with one copy. pio_adam_rows_staged makes the engine's whole round trip
//   (copy up, launch, copy down, wait) in one call from the host;
// - indexed (pio_adam_rows_indexed): rows, m and v are read at idx[r] from
//   resident [N, D] tables and the results written at idx[r] into three
//   output tables; g [R, D] and bc1, bc2 [R] are per touched row. idx holds
//   distinct rows (int32 or int64); a row outside [0, N) is left alone.
//
// What bounds it on an H100: bytes, and at the fold's sizes the launch.
// Each element is read 4 times and written 3 times for ~12 flops, ~0.4
// operations a byte. A micro-batch of 256 events touches at most 512 rows of
// D = rank + 1 = 33: 0.47 MB, ~0.14 us of HBM time, far below a launch's
// fixed cost. So the design cuts what stands between the launch and its
// last store: one warp a row (threadIdx.x the column, threadIdx.y the row of
// the block; 8 rows a block, chosen on the card against 2, 4, 16 and 32), so
// the row comes from the block and warp index with no division and the
// element offsets are 32-bit within a row; the row's two
// corrections are read once; every load of a pass (up to kSteps columns a
// lane: D <= 64 in one pass) is issued before its arithmetic, so a row costs
// one memory round trip (two for the indexed entry: idx, then the rows).
// The corrections come from the host, which computes them in double once per
// distinct step count, as the reference does.
//
// Bitwise agreement with the host numpy pass: every step is one IEEE fp32
// operation in the host's order, written with the _rn intrinsics so nvcc
// contracts nothing into an FMA; the scalars arrive as the host rounds them
// (fp32 of the Python doubles b1, 1 - b1, b2, 1 - b2, lr, eps). Every launch
// returns cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 32;       // one warp a row
constexpr int kRowsPerBlock = 8;  // 256 threads a block
constexpr int kSteps = 2;         // columns a lane a pass: D <= 64 in one

struct AdamScalars {
  float lr, b1, c1, b2, c2, eps;
};

// One adam step of row r: ``rows/m/v_in`` and ``rows/m/v_out`` are indexed at
// the row's table offset, ``g`` and the corrections at r. Idx is void for the
// stacked entry (the table row is r).
template <typename Idx>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
adam_rows_kernel(const float* __restrict__ rows_in,
                 const float* __restrict__ m_in,
                 const float* __restrict__ v_in,
                 const float* __restrict__ g, const float* __restrict__ bc1,
                 const float* __restrict__ bc2, float* __restrict__ rows_out,
                 float* __restrict__ m_out, float* __restrict__ v_out,
                 const Idx* __restrict__ idx, long long n_tab, int R, int D,
                 AdamScalars s) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (r >= R) return;
  const int lane = threadIdx.x;
  const float* gr = g + (size_t)r * D;
  const float c1r = bc1[r], c2r = bc2[r];
  size_t base = (size_t)r * D;
  if constexpr (!std::is_void_v<Idx>) {
    const long long t = (long long)idx[r];
    if (t < 0 || t >= n_tab) return;
    base = (size_t)t * D;
  }
  const float* x_in = rows_in + base;
  const float* m_row = m_in + base;
  const float* v_row = v_in + base;
  for (int c0 = 0; c0 < D; c0 += kLanes * kSteps) {
    float x[kSteps], m[kSteps], v[kSteps], gg[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int c = c0 + k * kLanes + lane;
      if (c < D) {
        x[k] = x_in[c];
        m[k] = m_row[c];
        v[k] = v_row[c];
        gg[k] = gr[c];
      }
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int c = c0 + k * kLanes + lane;
      if (c < D) {
        const float gi = gg[k];
        const float m2 = __fadd_rn(__fmul_rn(s.b1, m[k]), __fmul_rn(s.c1, gi));
        const float v2 = __fadd_rn(__fmul_rn(s.b2, v[k]),
                                   __fmul_rn(s.c2, __fmul_rn(gi, gi)));
        const float num = __fmul_rn(s.lr, __fdiv_rn(m2, c1r));
        const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2r)), s.eps);
        rows_out[base + c] = __fsub_rn(x[k], __fdiv_rn(num, den));
        m_out[base + c] = m2;
        v_out[base + c] = v2;
      }
    }
  }
}

template <typename Idx>
int launch(const float* rows_in, const float* m_in, const float* v_in,
           const float* g, const float* bc1, const float* bc2,
           float* rows_out, float* m_out, float* v_out, const Idx* idx,
           long long n_tab, int R, int D, AdamScalars s, void* stream) {
  if (R < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || D == 0) return 0;
  const dim3 block(kLanes, kRowsPerBlock);
  const unsigned grid = (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock);
  adam_rows_kernel<Idx><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rows_in, m_in, v_in, g, bc1, bc2, rows_out, m_out, v_out, idx, n_tab, R,
      D, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// in [4, R, D] f32, bc [2, R] f32, out [3, R, D] f32; c1 = fp32(1 - b1),
// c2 = fp32(1 - b2) rounded on the host from the doubles
int pio_adam_rows(const void* in, const void* bc, void* out, int R, int D,
                  float lr, float b1, float c1, float b2, float c2, float eps,
                  void* stream) {
  const size_t n = (size_t)R * D;
  const float* x = static_cast<const float*>(in);
  const float* b = static_cast<const float*>(bc);
  float* o = static_cast<float*>(out);
  return launch<void>(x, x + n, x + 2 * n, x + 3 * n, b, b + R, o, o + n,
                      o + 2 * n, nullptr, 0, R, D,
                      AdamScalars{lr, b1, c1, b2, c2, eps}, stream);
}

// The device engine's round trip in one call: host_in [4 R D + 2 R] f32
// (rows, m, v, g, bc1, bc2; pinned) is copied to dev_in, K3 writes dev_out
// [3, R, D], which is copied to host_out [3, R, D] (pinned), and the stream
// is synchronized: one copy up, one launch, one copy down, one wait.
int pio_adam_rows_staged(const void* host_in, void* dev_in, void* dev_out,
                         void* host_out, int R, int D, float lr, float b1,
                         float c1, float b2, float c2, float eps,
                         void* stream) {
  if (R < 0 || D < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)R * D;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, (4 * n + 2 * R) * 4,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* x = static_cast<const float*>(dev_in);
  int e = pio_adam_rows(x, x + 4 * n, dev_out, R, D, lr, b1, c1, b2, c2, eps,
                        stream);
  if (e != 0) return e;
  err = cudaMemcpyAsync(host_out, dev_out, 3 * n * 4, cudaMemcpyDeviceToHost,
                        st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  return static_cast<int>(err);
}

// table, m_tab, v_tab [N, D] f32 (read), idx [R] (idx_bytes 4 or 8), g [R, D],
// bc1, bc2 [R] f32, table_out, m_out, v_out [N, D] f32 (written at idx only)
int pio_adam_rows_indexed(const void* table, const void* m_tab,
                          const void* v_tab, const void* idx, int idx_bytes,
                          const void* g, const void* bc1, const void* bc2,
                          void* table_out, void* m_out, void* v_out,
                          long long N, int R, int D, float lr, float b1,
                          float c1, float b2, float c2, float eps,
                          void* stream) {
  const AdamScalars s{lr, b1, c1, b2, c2, eps};
  const auto* t = static_cast<const float*>(table);
  const auto* m = static_cast<const float*>(m_tab);
  const auto* v = static_cast<const float*>(v_tab);
  const auto* gg = static_cast<const float*>(g);
  const auto* b1p = static_cast<const float*>(bc1);
  const auto* b2p = static_cast<const float*>(bc2);
  auto* to = static_cast<float*>(table_out);
  auto* mo = static_cast<float*>(m_out);
  auto* vo = static_cast<float*>(v_out);
  if (idx_bytes == 4)
    return launch<int32_t>(t, m, v, gg, b1p, b2p, to, mo, vo,
                           static_cast<const int32_t*>(idx), N, R, D, s,
                           stream);
  if (idx_bytes == 8)
    return launch<int64_t>(t, m, v, gg, b1p, b2p, to, mo, vo,
                           static_cast<const int64_t*>(idx), N, R, D, s,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
