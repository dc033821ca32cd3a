// Row-block adam of the streaming fold, written by hand for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes).
//
// K3  pio_adam_rows  replaces incubator_predictionio_tpu/ops/sparse_update.py
//                    _pallas_adam_rows (the Pallas _adam_rows_kernel): one
//                    adam step over a stack of touched rows, each row with
//                    its own bias corrections:
//        m'   = b1 m + (1 - b1) g
//        v'   = b2 v + (1 - b2) (g g)
//        row' = row - lr (m' / bc1[r]) / (sqrt(v' / bc2[r]) + eps)
//
// Layout: ``in`` is one [4, R, D] fp32 block (rows, m, v, g) and ``bc`` one
// [2, R] block (bc1, bc2), so the wrapper uploads a micro-batch with one
// copy; ``out`` is [3, R, D] (rows, m, v), downloaded with one copy.
//
// What bounds it on an H100: bytes, and at the fold's sizes the launch.
// Each element is read 4 times and written 3 times for ~12 flops: a flat
// elementwise pass at ~0.4 operations per byte. A micro-batch of 256
// events touches at most 512 rows of D = rank + 1 = 33 — 0.47 MB, ~0.14 us
// of HBM time, far below a launch's few microseconds. So the design is the
// simplest correct one: a grid-stride loop over the R * D elements, row =
// i / D for the two bias corrections (which the host computes in double
// once per distinct step count, as the reference does), no padding of R
// (the TPU's ROW_BLOCK buckets bound its executables; CUDA compiles once)
// and no vector loads (D = 33 is odd).
//
// Bitwise agreement with the host numpy pass: every step is one IEEE fp32
// operation in the host's order, written with the _rn intrinsics so nvcc
// contracts nothing into an FMA; the scalars arrive as the host rounds them
// (fp32 of the Python doubles b1, 1 - b1, b2, 1 - b2, lr, eps). Every launch
// returns cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks an SM on an H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
adam_rows_kernel(const float* __restrict__ in, const float* __restrict__ bc,
                 float* __restrict__ out, int R, int D, float lr, float b1,
                 float c1, float b2, float c2, float eps) {
  const size_t n = (size_t)R * D;
  const float* rows = in;
  const float* m = in + n;
  const float* v = in + 2 * n;
  const float* g = in + 3 * n;
  const float* bc1 = bc;
  const float* bc2 = bc + R;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / (size_t)D);
    const float gi = g[i];
    const float m2 = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(c1, gi));
    const float v2 =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(c2, __fmul_rn(gi, gi)));
    const float num = __fmul_rn(lr, __fdiv_rn(m2, bc1[r]));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2[r])), eps);
    out[i] = __fsub_rn(rows[i], __fdiv_rn(num, den));
    out[n + i] = m2;
    out[2 * n + i] = v2;
  }
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
  if (n == 0) return 0;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (size_t)kMaxBlocks) blocks = kMaxBlocks;
  adam_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(bc),
      static_cast<float*>(out), R, D, lr, b1, c1, b2, c2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
