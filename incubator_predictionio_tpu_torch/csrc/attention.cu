// Causal multi-head attention of the sequential recommender for small heads
// (kernel K4), forward and backward, written by hand for Hopper (sm_90a) and
// bound to PyTorch through a plain C interface (ctypes).
//
// What it replaces: incubator_predictionio_tpu/ops/attention.py, the Pallas
// kernels of causal_mha_small_head:
//
//   pio_causal_mha_small_head      _mha_fwd (:122, pallas_call :125, kernel
//                                  _fwd_kernel :56): p = exp(s - m) / l
//                                  normalised in fp32 with the row's final
//                                  max m and sum l, rounded to bf16 (round to
//                                  nearest even, as astype(bfloat16)), and
//                                  p.v summed in fp32 with no final division.
//                                  Given m and l pointers (null when serving)
//                                  it also writes each row's m (natural-log
//                                  units, of the scaled scores) and l, fp32
//                                  [B, H, L] — stored after the output, which
//                                  stays bitwise the same.
//   pio_causal_mha_small_head_bwd  _mha_bwd (:136, pallas_call :141, kernel
//                                  _bwd_kernel :75): the row term
//                                  t = rowsum(dp . p) from fp32 p and dp
//                                  (:99), ds = p . (dp - t) . scale rounded to
//                                  bf16, p rounded to bf16 for dv, every sum
//                                  fp32. Two launches on one stream: the dq
//                                  kernel (which also writes t into the fp32
//                                  scratch it is given), then the dk/dv
//                                  kernel, which reads t.
//
// The TPU kernel holds a whole [L, L] fp32 score block per head in VMEM (1 MB
// at L 512, against a block's 227 KB of shared memory here), so these tile
// queries and keys. p = exp(s - m) / l needs m and l before the first p, so
// the forward makes two passes over the key tiles: pass 1 for m and l, pass 2
// for p.v. Exponentials are exp2 of one FMA (scale.log2(e) folded in,
// ex2.approx.ftz), and p multiplies by 1 / l instead of dividing by l; m goes
// back in natural-log units. The backward takes m and l from the forward (the
// numbers the TPU kernel's backward recomputes).
//
// Layout: q, k, v, out (and do, dq, dk, dv) [B, H, L, D] bf16, contiguous;
// D in {32, 64, 128}; L a multiple of 64; scale 1/sqrt(D).
//
// What bounds it on an H100, at the serving and training shape (B 64, H 8,
// L 512, D 64): bytes. The forward's causal half of q.k^T and p.v is
// 2.B.H.L^2.D = 17.2 GFLOP (0.0174 ms at 989 TFLOP/s) against 134 MB of q,
// k, v and out (0.0401 ms at 3.35 TB/s): 128 operations a byte, under the
// ~295 where the bf16 tensor cores become the limit; with the statistics
// pass's extra q.k^T, ~192 a byte, still under it. The backward moves 7 such
// tensors (0.0707 ms) for the function's 5 products (43 GFLOP, 0.0434 ms);
// this one's 9 products (77 GFLOP, 0.078 ms) bring it to the operations
// bound. So a kernel near its bound streams q, k, v once, keeps every [L, L]
// tile out of device memory and keeps the tensor cores fed. The design
// (K5's, csrc/flash_attention.cu; its building blocks are shared in
// attention_sm90.cuh):
//
// - wgmma m64nNk16, bf16 in, fp32 sums in registers: s = q.k^T (and in the
//   backward dp = do.v^T, s^T = k.q^T, dp^T = v.do^T) from two shared-memory
//   tiles; p.v, ds.k, p^T.do, ds^T.q with p or ds from registers.
// - Scores, p and ds never leave registers: the accumulator's layout is
//   known, so row maxima and sums are taken with __shfl_xor_sync among the
//   4 lanes that hold a row, and p and ds are rounded to bf16 and repacked
//   in registers as the next product's A operand.
// - Tiles in wgmma's canonical swizzled layouts (128-byte rows, 64-byte at D
//   32), filled by cp.async.cg into a ring of 2 stages: the next tile is in
//   flight while the current one's products run; one fence.proxy.async and
//   one __syncthreads a tile.
// - Forward and dq: one block of 2 warpgroups per 128-row query tile, heavy
//   tiles first (the tile index is the grid's slowest dimension), walking
//   64-key tiles; a warpgroup skips the key tiles above its rows and masks
//   only the tile on its diagonal; a ragged last tile (L a multiple of 64,
//   not of 128) runs with its second warpgroup idle.
// - The forward's two passes run one instruction sequence for s (score_tile),
//   so pass 2's scores are bitwise pass 1's and p <= 1/l. Pass 1 streams K
//   tiles alone; pass 2 streams K and V; the ring runs across the boundary
//   (pass 2's first tile is in flight while pass 1's last computes).
// - dq (shared body dq_rows, with the row-term walk): walk 1 computes s and
//   dp per key tile and sums p.dp in registers (2 products a tile); walk 2
//   forms ds and dq += ds.k (3 products), the 64-key tile in 32-key halves.
// - dk/dv (shared body dkv_keys): one warpgroup per 64-key tile,
//   FlashAttention-2's arrangement; 4 products a step.
//
// Not used yet (later work): TMA and a producer warp; softmax overlapped
// with the products. Every launch returns cudaGetLastError() and the Python
// wrapper raises when it is not 0.

#include "attention_sm90.cuh"

namespace {

// s = q.k^T of the warpgroup's 64 rows (from row wg * 64 of the query tile)
// against a 64-key tile, the keys above the warp's rows at -inf: the one
// instruction sequence both forward passes run
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[kKeys / 8][4], uint32_t q_addr,
                                           int wg, uint32_t k_addr, int k0, int rw,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  wg_abt<D, kKeys>(s, q_addr, RowCfg<D>::kRows, wg * 64, k_addr, kKeys, 0);
  if (k0 + kKeys - 1 > rw) {  // the tile crosses the warp's diagonal
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) > rw + g + (e >> 1) * 8) s[j][e] = -INFINITY;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(RowCfg<D>::kThreads)
small_head_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out, int L,
                      float scale_log2) {
  using C = RowCfg<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* kv_s = q_s + C::kRowTile;  // stage s: K, V at tiles 2s, 2s + 1
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const QueryTile tile(L, C::kRows);
  const int n_kt = tile.n_kt;
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const bf16* k_head = k + bh * L * D;
  const bf16* v_head = v + bh * L * D;
  const uint32_t q_addr = smem_addr(q_s);

  copy_rows<D, C::kThreads>(q_s, q + (bh * L + tile.q0) * D, tile.rows, C::kRows);
  copy_rows<D, C::kThreads>(kv_s, k_head, kKeys, kKeys);
  cp_async_commit();

  const int r0 = tile.q0 + wg * 64;  // the warpgroup's first row
  const bool active = r0 < L;        // false in a ragged tile's second half
  const int rw = r0 + warp * 16;     // the warp's first row
  // rows g and g + 8: max (log2 units) and this lane's share of the sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // pass 1: ring step kt holds K tile kt
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warpgroup is done with step kt - 1
    unsigned char* next = kv_s + ((kt + 1) & 1) * 2 * C::kKeyTile;
    if (kt + 1 < n_kt)
      copy_rows<D, C::kThreads>(next, k_head + (size_t)(kt + 1) * kKeys * D, kKeys, kKeys);
    else
      load_kv<D>(next, k_head, v_head, 0);  // pass 2's first tile
    cp_async_commit();
    const int k0 = kt * kKeys;
    if (!active || k0 > r0 + 63) continue;  // every key above the warpgroup's rows
    float s[kKeys / 8][4];
    score_tile<D>(s, q_addr, wg, smem_addr(kv_s + (kt & 1) * 2 * C::kKeyTile), k0, rw, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // key 0 is in every row's first tile, so m_new is finite and the
      // first rescale is exp2(-inf) = 0
      const float m_new = fmaxf(m_run[i], quad_max(mx[i]) * scale_log2);
      l_run[i] *= exp2_ftz(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l_run[e >> 1] += exp2_ftz(fmaf(s[j][e], scale_log2, -m_run[e >> 1]));
    }
  }
  float inv_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] = quad_sum(l_run[i]);
    inv_l[i] = 1.f / l_run[i];
  }

  // pass 2: ring step n_kt + kt holds K and V tile kt
  float o[D / 8][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt)
      load_kv<D>(kv_s + ((n_kt + kt + 1) & 1) * 2 * C::kKeyTile, k_head, v_head, kt + 1);
    cp_async_commit();
    const int k0 = kt * kKeys;
    if (!active || k0 > r0 + 63) continue;
    const uint32_t k_addr = smem_addr(kv_s + ((n_kt + kt) & 1) * 2 * C::kKeyTile);
    float s[kKeys / 8][4];
    score_tile<D>(s, q_addr, wg, k_addr, k0, rw, g, t);
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2_ftz(fmaf(s[j][e], scale_log2, -m_run[e >> 1])) * inv_l[e >> 1];
    }
    uint32_t pa[kKeys / 16][4];
    to_a<kKeys>(pa, s);
    wg_pb<D, kKeys>(o, pa, k_addr + C::kKeyTile, kKeys, 0);  // o += p . v
  }
  if (!active) return;

  store_rows<D>(out + (bh * L + rw) * D, o, lane);
  if (m_out != nullptr && t == 0) {  // the backward's residuals
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t stat = bh * L + rw + g + 8 * i;
      m_out[stat] = m_run[i] * kLn2;
      l_out[stat] = l_run[i];
    }
  }
}

// the backward bodies (attention_sm90.cuh) under K4's kernel names
template <int D>
__global__ void __launch_bounds__(RowCfg<D>::kThreads, D > 64 ? 1 : 2)
small_head_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ m_rows,
                         const float* __restrict__ l_rows, float* __restrict__ t_rows,
                         bf16* __restrict__ dq, int L, float scale, float scale_log2) {
  dq_rows<D, true>(q, k, v, dout, m_rows, l_rows, nullptr, t_rows, dq, L, scale,
                   scale_log2);
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads)
small_head_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ m_rows,
                          const float* __restrict__ l_rows,
                          const float* __restrict__ t_rows, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int L, float scale, float scale_log2) {
  dkv_keys<D>(q, k, v, dout, m_rows, l_rows, t_rows, dk, dv, L, scale, scale_log2);
}

// -- launchers ----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  void *out, *m, *l;  // forward: out, and m, l (both null when serving);
                      // backward: m, l from the forward
  void* t;            // backward: the row term, fp32 [B, H, L] scratch
  void *dq, *dk, *dv;
};

template <int D>
cudaError_t launch(bool backward, const Args& a, int B, int H, int L,
                   cudaStream_t stream) {
  using R = RowCfg<D>;
  const double scale = 1.0 / sqrt((double)D);  // the reference's 1/math.sqrt(d)
  const float scale_f = (float)scale, scale_log2 = (float)(scale * 1.4426950408889634);
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const dim3 rows_grid(H, B, (L + R::kRows - 1) / R::kRows);
  cudaError_t err;
  if (!backward) {
    err = set_smem(small_head_fwd_kernel<D>, R::kFwdSmem);
    if (err != cudaSuccess) return err;
    small_head_fwd_kernel<D><<<rows_grid, R::kThreads, R::kFwdSmem, stream>>>(
        q, k, v, static_cast<bf16*>(a.out), static_cast<float*>(a.m),
        static_cast<float*>(a.l), L, scale_log2);
    return cudaGetLastError();
  }
  const float *m = static_cast<const float*>(a.m), *l = static_cast<const float*>(a.l);
  float* t = static_cast<float*>(a.t);
  // dq first: it writes the row term the dk/dv kernel reads (one stream)
  err = set_smem(small_head_bwd_dq_kernel<D>, R::kDqSmem);
  if (err != cudaSuccess) return err;
  small_head_bwd_dq_kernel<D><<<rows_grid, R::kThreads, R::kDqSmem, stream>>>(
      q, k, v, dout, m, l, t, static_cast<bf16*>(a.dq), L, scale_f, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(small_head_bwd_dkv_kernel<D>, DkvCfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  small_head_bwd_dkv_kernel<D><<<dim3(H, B, L / kKeys), DkvCfg<D>::kThreads,
                                 DkvCfg<D>::kSmem, stream>>>(
      q, k, v, dout, m, l, t, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), L,
      scale_f, scale_log2);
  return cudaGetLastError();
}

int dispatch(bool backward, const Args& a, int B, int H, int L, int D, void* stream) {
  if (L % kKeys != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(backward, a, B, H, L, s); break;
    case 64: err = launch<64>(backward, a, B, H, L, s); break;
    case 128: err = launch<128>(backward, a, B, H, L, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward: m and l are both null (serving) or both fp32 [B, H, L]
int pio_causal_mha_small_head(const void* q, const void* k, const void* v,
                              void* out, void* m, void* l, int B, int H, int L,
                              int D, void* stream) {
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(false, Args{q, k, v, nullptr, out, m, l, nullptr, nullptr, nullptr, nullptr},
                  B, H, L, D, stream);
}

// The backward: m, l from the forward; t is fp32 [B, H, L] scratch the dq
// kernel fills with the row term
int pio_causal_mha_small_head_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* m,
                                  const void* l, void* t, void* dq, void* dk,
                                  void* dv, int B, int H, int L, int D,
                                  void* stream) {
  if (m == nullptr || l == nullptr || t == nullptr || dq == nullptr ||
      dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(true,
                  Args{q, k, v, dout, nullptr, const_cast<void*>(m), const_cast<void*>(l),
                       t, dq, dk, dv},
                  B, H, L, D, stream);
}

}  // extern "C"
