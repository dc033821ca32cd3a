// Causal flash attention of the sequential recommender at long sequences
// (kernel K5), forward and backward, written by hand for Hopper (sm_90a) and
// bound to PyTorch through a plain C interface (ctypes).
//
// What it replaces: incubator_predictionio_tpu/parallel/ring.py:201, where
// causal_attention calls the library Pallas flash_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//
//   pio_flash_causal          the forward, _flash_attention_kernel (:342,
//                             pallas_call :758): one pass of online softmax,
//                             a running max and sum, the fp32 accumulator
//                             rescaled by exp(m_old - m_new), p rounded to
//                             bf16 before PV, one division by l at the end.
//                             Given m and l pointers (null when serving) it
//                             also writes each row's final max m (natural-log
//                             units, of the scaled scores) and sum
//                             l = sum exp(s - m), fp32 [B, H, L] — stores
//                             after the output, which stays bitwise the same.
//   pio_flash_causal_bwd_dkv  _flash_attention_dkv_kernel (:796, pallas_call
//                             :1121): dv = sum p^T.do, dk = sum ds^T.q.
//   pio_flash_causal_bwd_dq   _flash_attention_dq_kernel (:1146, wrapper
//                             :1287, pallas_call :1456): dq = sum ds.k.
//
// The backward forms p = exp(s - m) * (1 / l) from the forward's m and l,
// takes di = rowsum(o . do) from the caller (a torch reduction over the bf16
// o, as the library computes it outside its kernels, :273), and forms
// ds = (dp - di) * p * scale; p and ds are rounded to bf16 before their
// products, every sum is fp32. Two kernels, each deterministic: the dk/dv
// kernel computes s and dp for its tiles, and so does the dq kernel — 7 tile
// products against the function's 5, like the library's two kernels.
//
// Layout: q, k, v, out (and do, dq, dk, dv) [B, H, L, D] bf16, contiguous;
// D in {32, 64, 128}; L a multiple of 64; scale 1/sqrt(D).
//
// What bounds it on an H100. The forward's causal half of q.k^T and p.v is
// 2.B.H.L^2.D operations against 4.B.H.L.D.2 bytes of q, k, v and out: at
// D 64 that is 128 operations a byte at L 512 — under the ~295 where the
// bf16 tensor cores, not HBM, become the limit, so bytes bound it there —
// and 256 at L 1024, nearly balanced. The backward does 5 products over the
// causal half against 7 such tensors: at L 1024 its operations bound it. So
// a kernel near its bound must stream q, k, v once, keep every [L, L] tile
// out of device memory AND keep the tensor cores fed. The design:
//
// - Tensor cores through wgmma: a warpgroup (4 warps) multiplies 64 rows at
//   a time, m64nNk16, bf16 in, fp32 sums in registers. Products of two
//   tiles read both from shared memory (s = q.k^T; in the backward also
//   dp = do.v^T, and s^T = k.q^T, dp^T = v.do^T); products by p or ds take
//   it from registers and read the other tile transposed (MN-major): p.v,
//   ds.k, p^T.do, ds^T.q.
// - Every score tile stays in registers. The accumulator's layout is known
//   (each warp its 16 rows, as mma.sync m16n8's): the row max and sum are
//   taken there with __shfl_xor_sync among the 4 lanes that hold a row, p
//   (and ds) is rounded to bf16 in registers and used directly as the A
//   operand of the next product (an accumulator pair of n8 tiles is an A
//   fragment of k16), and the output accumulator is rescaled in registers.
//   No score, p, ds or p.v tile goes through shared memory. scale.log2(e)
//   is folded into the exponentials (ex2.approx.ftz of one FMA); m is
//   written back in natural-log units.
// - Shared-memory tiles in wgmma's canonical swizzled layouts (128-byte rows
//   at D 64 and 128, 64-byte rows at D 32), which are also free of bank
//   conflicts.
// - Asynchronous copies: cp.async.cg of 16 bytes a thread into a ring of 2
//   shared-memory stages. The next key tile (forward, dq) or query tile
//   (dk/dv) is in flight while the current one's products run; one
//   fence.proxy.async and one __syncthreads a tile.
// - The forward and the dq kernel: one block of 2 warpgroups per 128-row
//   query tile, walking 64-key tiles. A ragged last tile (L a multiple of
//   64, not of 128) runs with its second warpgroup idle. A warpgroup skips
//   the key tiles above its rows and masks only the tile on its diagonal.
// - The dk/dv kernel (FlashAttention-2's arrangement): one warpgroup per
//   64-key tile. k and v stay in shared memory; q, do and the rows' m, l,
//   di stream through the ring, 64 query rows a step (32 at D 128). It
//   computes s^T = k.q^T and dp^T = v.do^T, so p^T and ds^T come out of the
//   accumulators already in the A layout of dv += p^T.do and dk += ds^T.q;
//   m, l and di are per column there and read from the stage.
// - Heavy tiles first: the tile index is the grid's slowest dimension, so
//   the longest query tiles (forward, dq) and the first key tiles (dk/dv) of
//   every head are scheduled before the short ones.
//
// The building blocks above, and the bodies of the dq and dk/dv kernels,
// live in attention_sm90.cuh, shared with K4 (csrc/attention.cu); the
// forward is K5's own.
//
// Not used yet (later work): TMA and a producer warp; overlapping a tile's
// softmax with the next tile's products inside a warpgroup (tried: with a
// second score tile in registers the forward needs 144 registers a thread,
// one block an SM, and ran 1.7x slower). Every launch returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include "attention_sm90.cuh"

namespace {

// -- the forward: one block per 128-row query tile ----------------------------

template <int D>
__global__ void __launch_bounds__(RowCfg<D>::kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const bf16* k_head = k + bh * L * D;
  const bf16* v_head = v + bh * L * D;

  copy_rows<D, C::kThreads>(q_s, q + (bh * L + tile.q0) * D, tile.rows, C::kRows);
  load_kv<D>(kv_s, k_head, v_head, 0);
  cp_async_commit();

  const int r0 = tile.q0 + wg * 64;  // the warpgroup's first row
  const bool active = r0 < L;        // false in a ragged tile's second half
  const int rw = r0 + warp * 16;     // the warp's first row
  float o[D / 8][4] = {};
  // rows g and g + 8: running max (log2 units) and this lane's share of the sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < tile.n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warpgroup is done with tile kt - 1
    if (kt + 1 < tile.n_kt)
      load_kv<D>(kv_s + ((kt + 1) & 1) * 2 * C::kKeyTile, k_head, v_head, kt + 1);
    cp_async_commit();
    const int k0 = kt * kKeys;
    if (!active || k0 > r0 + 63) continue;  // every key above the warpgroup's rows
    const uint32_t k_addr = smem_addr(kv_s + (kt & 1) * 2 * C::kKeyTile);

    float s[kKeys / 8][4] = {};
    wg_abt<D, kKeys>(s, smem_addr(q_s), C::kRows, wg * 64, k_addr, kKeys, 0);
    if (k0 + kKeys - 1 > rw) {  // the tile crosses the warp's diagonal
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) > rw + g + (e >> 1) * 8) s[j][e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // key 0 is in every row's first tile, so m_new is finite and the
      // first alpha is exp2(-inf) = 0
      const float m_new = fmaxf(m_run[i], quad_max(mx[i]) * scale_log2);
      alpha[i] = exp2_ftz(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(fmaf(s[j][e], scale_log2, -m_run[e >> 1]));
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    uint32_t pa[kKeys / 16][4];
    to_a<kKeys>(pa, s);
    wg_pb<D, kKeys>(o, pa, k_addr + C::kKeyTile, kKeys, 0);  // o += p . v
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = quad_sum(l_run[i]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] /= l_run[e >> 1];
  }
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

// the backward bodies (attention_sm90.cuh) under K5's kernel names
template <int D>
__global__ void __launch_bounds__(RowCfg<D>::kThreads, D > 64 ? 1 : 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ m_rows,
                    const float* __restrict__ l_rows,
                    const float* __restrict__ di_rows, bf16* __restrict__ dq,
                    int L, float scale, float scale_log2) {
  dq_rows<D, false>(q, k, v, dout, m_rows, l_rows, di_rows, nullptr, dq, L, scale,
                    scale_log2);
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ m_rows,
                     const float* __restrict__ l_rows,
                     const float* __restrict__ di_rows, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, float scale, float scale_log2) {
  dkv_keys<D>(q, k, v, dout, m_rows, l_rows, di_rows, dk, dv, L, scale, scale_log2);
}

// -- launchers ----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  void *out, *m, *l;  // forward: out, and m, l (both null when serving)
  const void* di;     // backward: di = rowsum(o . do); m, l from the forward
  void *dq, *dk, *dv;
};

enum class Pass { kForward, kDkv, kDq };

template <int D>
cudaError_t launch(Pass pass, const Args& a, int B, int H, int L,
                   cudaStream_t stream) {
  using R = RowCfg<D>;
  const double scale = 1.0 / sqrt((double)D);  // the reference's 1/math.sqrt(d)
  const float scale_f = (float)scale, scale_log2 = (float)(scale * 1.4426950408889634);
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const float *m = static_cast<const float*>(a.m), *l = static_cast<const float*>(a.l),
              *di = static_cast<const float*>(a.di);
  cudaError_t err = cudaSuccess;
  const dim3 rows_grid(H, B, (L + R::kRows - 1) / R::kRows);
  switch (pass) {
    case Pass::kForward:
      err = set_smem(flash_fwd_kernel<D>, R::kFwdSmem);
      if (err != cudaSuccess) return err;
      flash_fwd_kernel<D><<<rows_grid, R::kThreads, R::kFwdSmem, stream>>>(
          q, k, v, static_cast<bf16*>(a.out), static_cast<float*>(a.m),
          static_cast<float*>(a.l), L, scale_log2);
      break;
    case Pass::kDq:
      err = set_smem(flash_bwd_dq_kernel<D>, R::kDqSmem);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_kernel<D><<<rows_grid, R::kThreads, R::kDqSmem, stream>>>(
          q, k, v, dout, m, l, di, static_cast<bf16*>(a.dq), L, scale_f, scale_log2);
      break;
    case Pass::kDkv:
      err = set_smem(flash_bwd_dkv_kernel<D>, DkvCfg<D>::kSmem);
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_kernel<D><<<dim3(H, B, L / kKeys), DkvCfg<D>::kThreads,
                                DkvCfg<D>::kSmem, stream>>>(
          q, k, v, dout, m, l, di, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), L, scale_f, scale_log2);
      break;
  }
  return cudaGetLastError();
}

int dispatch(Pass pass, const Args& a, int B, int H, int L, int D, void* stream) {
  if (L % kKeys != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(pass, a, B, H, L, s); break;
    case 64: err = launch<64>(pass, a, B, H, L, s); break;
    case 128: err = launch<128>(pass, a, B, H, L, s); break;
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
int pio_flash_causal(const void* q, const void* k, const void* v, void* out,
                     void* m, void* l, int B, int H, int L, int D,
                     void* stream) {
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(Pass::kForward,
                  Args{q, k, v, nullptr, out, m, l, nullptr, nullptr, nullptr, nullptr},
                  B, H, L, D, stream);
}

// The backward, dk and dv: m, l from the forward, di = rowsum(o . do)
int pio_flash_causal_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             const void* di, void* dk, void* dv, int B, int H,
                             int L, int D, void* stream) {
  if (dk == nullptr || dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(Pass::kDkv,
                  Args{q, k, v, dout, nullptr, const_cast<void*>(m),
                       const_cast<void*>(l), di, nullptr, dk, dv},
                  B, H, L, D, stream);
}

// The backward, dq
int pio_flash_causal_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* m, const void* l,
                            const void* di, void* dq, int B, int H, int L,
                            int D, void* stream) {
  if (dq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(Pass::kDq,
                  Args{q, k, v, dout, nullptr, const_cast<void*>(m),
                       const_cast<void*>(l), di, dq, nullptr, nullptr},
                  B, H, L, D, stream);
}

}  // extern "C"

