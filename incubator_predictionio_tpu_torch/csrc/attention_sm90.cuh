// Hopper (sm_90a) building blocks of the causal-attention kernels: shared by
// csrc/attention.cu (K4, the small-head kernel) and csrc/flash_attention.cu
// (K5, the flash kernel), each of which includes it into its own library.
// csrc/retrieval.cu (K1) includes it for its PTX wrappers alone.
//
// - PTX wrappers: cp.async into shared memory, the async-proxy fence, wgmma
//   fences and waits, ex2.approx, bf16 packing;
// - wgmma m64nNk16 (bf16 in, fp32 sums in registers), both operands from
//   shared memory (ss) or A from registers (rs), with their descriptors;
// - shared-memory tiles in wgmma's canonical swizzled layouts, filled by
//   cp.async (copy_rows);
// - warpgroup products (wg_abt, wg_pb) and register helpers (to_a,
//   store_rows, quad_max, quad_sum);
// - the tilings of the row kernels (RowCfg, QueryTile: one block of 2
//   warpgroups per 128-row query tile) and of the dk/dv kernel (DkvCfg: one
//   warpgroup per 64-key tile);
// - the two backward bodies both libraries run: dq_rows (dq of a query
//   tile; K4 also takes its row term there) and dkv_keys (dk, dv of a key
//   tile). Each library wraps them in __global__ kernels of its own names.
//
// Every library build hashes this header with its source
// (ops/_build.py:library_path), so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;  // keys a tile of the row kernels (forward, dq)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (swizzled tiles start there)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies are in, and visible to wgmma (the async proxy)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0 (p
// below 2^-126 of the row's largest term)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- wgmma ---------------------------------------------------------------------
//
// Accumulator layout of m64nNk16 (f32) in a warpgroup: warp w holds rows
// 16w..16w+15; its lane (g = lane / 4, t = lane % 4) holds d[j][0], d[j][1] at
// row 16w + g, columns 8j + 2t, 8j + 2t + 1 and d[j][2], d[j][3] at row
// 16w + g + 8, the same columns. An A operand from registers has the layout
// of an mma.sync m16n8k16 A fragment, each warp its 16 rows.

// d[64, N] (+)= a[64, 16] . b[16, N]: a and b K-major in shared memory;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64, N] += a[64, 16] . b[16, N]: a in registers, b MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, da, db, scale_d);
  } else {
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// -- shared-memory tiles ------------------------------------------------------
//
// A [rows, D] bf16 tile is stored in column blocks of kRowBytes (128 bytes
// at D >= 64, 64 at D 32); inside a block, row r's 16-byte chunk c sits at
// chunk c ^ (r % 8) (128-byte swizzle) or c ^ (r / 2 % 4) (64-byte
// swizzle). Tiles start 1024-byte aligned.
template <int D>
struct Swz {
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kAtom = 8 * kRowBytes;         // bytes of 8 rows
  static constexpr uint64_t kMode = D >= 64 ? 1 : 2;  // descriptor: 128B / 64B swizzle
  __device__ static int offset(int r, int c, int rows) {
    const int sw = D >= 64 ? (r & 7) : ((r >> 1) & 3);
    return (c / kChunks) * rows * kRowBytes + r * kRowBytes + (((c % kChunks) ^ sw) << 4);
  }
};

// rows [0, n) of a row-major [*, D] bf16 tensor into a tile of `rows` rows,
// 16 bytes a thread a step, asynchronously
template <int D, int kThreads>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src, int n,
                                          int rows) {
  constexpr int kC = D / 8;
  for (int i = threadIdx.x; i < n * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    cp_async16(dst + Swz<D>::offset(r, c, rows), src + (size_t)r * D + c * 8);
  }
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// k16 step kk of a tile of `rows` rows read K-major, from its row row0
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int row0,
                                                 int kk) {
  using S = Swz<D>;
  const int byte = kk * 32;
  return gmma_desc(tile + (byte / S::kRowBytes) * rows * S::kRowBytes +
                       row0 * S::kRowBytes + byte % S::kRowBytes,
                   16, S::kAtom, S::kMode);
}

// rows 16kk..16kk+15 of a tile of `rows` rows read MN-major (K = its rows,
// N = D)
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows, int kk) {
  using S = Swz<D>;
  return gmma_desc(tile + kk * 16 * S::kRowBytes, rows * S::kRowBytes, S::kAtom,
                   S::kMode);
}

// -- warpgroup products and register helpers ----------------------------------

// acc[64, N] = a[64, D] . b[N, D]^T: rows a_row0.. of a tile a of a_rows
// rows and rows b_row0.. of a tile b of b_rows rows, both read K-major
template <int D, int N>
__device__ __forceinline__ void wg_abt(float (&acc)[N / 8][4], uint32_t a, int a_rows,
                                       int a_row0, uint32_t b, int b_rows, int b_row0) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(acc, desc_k_major<D>(a, a_rows, a_row0, kk),
                desc_k_major<D>(b, b_rows, b_row0, kk), kk > 0);
  wgmma_commit_and_wait();
  fence_regs(acc);
}

// acc[64, D] += pa[64, K] . b[K, D]: pa in registers, b rows b_row0.. of a
// tile of b_rows rows
template <int D, int K>
__device__ __forceinline__ void wg_pb(float (&acc)[D / 8][4],
                                      const uint32_t (&pa)[K / 16][4], uint32_t b,
                                      int b_rows, int b_row0) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk], desc_mn_major<D>(b, b_rows, b_row0 / 16 + kk));
  wgmma_commit_and_wait();
  fence_regs(acc);
}

// a warp's [16, K] fp32 accumulator rounded to bf16 A fragments of k16
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&pa)[K / 16][4],
                                     const float (&p)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// a warp's [16, D] fp32 accumulator to 16 rows of a [*, D] bf16 tensor
// (dst: the warp's first row)
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(g + 8 * i) * D + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- the forward and dq kernels: one block per 128-row query tile -------------

template <int D>
struct RowCfg {
  static constexpr int kRows = 128;    // 2 warpgroups of 64 query rows
  static constexpr int kThreads = 256;
  static constexpr int kRowTile = kRows * D * 2;    // bytes of Q (or dO)
  static constexpr int kKeyTile = kKeys * D * 2;    // bytes of one K or V stage
  // Q (dq: Q and dO), then 2 stages of (K, V), and room to align the start
  static constexpr size_t kFwdSmem = 1024 + kRowTile + 4 * kKeyTile;
  static constexpr size_t kDqSmem = kFwdSmem + kRowTile;
};

// the block's query tile: heavy tiles first (gridDim.z walks them), and the
// key tiles it needs (keys up to its last row)
struct QueryTile {
  int q0, rows, n_kt;
  __device__ QueryTile(int L, int tile_rows) {
    const int n_qt = (L + tile_rows - 1) / tile_rows;
    q0 = (n_qt - 1 - (int)blockIdx.z) * tile_rows;
    rows = min(tile_rows, L - q0);
    n_kt = (q0 + rows) / kKeys;
  }
};

// key tile kt of K and V into a stage
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* stage, const bf16* k,
                                        const bf16* v, int kt) {
  using C = RowCfg<D>;
  copy_rows<D, C::kThreads>(stage, k + (size_t)kt * kKeys * D, kKeys, kKeys);
  copy_rows<D, C::kThreads>(stage + C::kKeyTile, v + (size_t)kt * kKeys * D, kKeys, kKeys);
}

template <int D>
struct DkvCfg {
  static constexpr int kThreads = 128;         // 4 warps of 16 keys
  static constexpr int kQ = D > 64 ? 32 : 64;  // query rows a step
  static constexpr int kKeyTile = kKeys * D * 2;
  static constexpr int kQTile = kQ * D * 2;
  // a stage: Q, dO, then m, l and the row term (fp32, kQ each),
  // 1024-byte aligned
  static constexpr int kStage = (2 * kQTile + 3 * kQ * 4 + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + 2 * kKeyTile + 2 * kStage;
};

template <int D>
__device__ __forceinline__ void load_q_step(unsigned char* stage, const bf16* q,
                                            const bf16* dout, const float* m,
                                            const float* l, const float* t_rows,
                                            size_t row0) {
  using C = DkvCfg<D>;
  copy_rows<D, C::kThreads>(stage, q + row0 * D, C::kQ, C::kQ);
  copy_rows<D, C::kThreads>(stage + C::kQTile, dout + row0 * D, C::kQ, C::kQ);
  float* stats = reinterpret_cast<float*>(stage + 2 * C::kQTile);
  constexpr int kChunks = C::kQ / 4;  // 16 bytes of fp32 each
  for (int i = threadIdx.x; i < 3 * kChunks; i += C::kThreads) {
    const int which = i / kChunks, c = i % kChunks;
    const float* src = which == 0 ? m : (which == 1 ? l : t_rows);
    cp_async16(stats + which * C::kQ + c * 4, src + row0 + c * 4);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// -- the backward bodies --------------------------------------------------------
//
// Both form p = exp(s - m) / l from the forward's m and l (as exp2 of one
// FMA, times 1 / l), ds = (dp - t) . p . scale with t the row term, and
// round p and ds to bf16 before their products; every sum is fp32.

// dq of one 128-row query tile (a block of 2 warpgroups), walking the key
// tiles up to its last row: dq = sum ds . k, the 64-key tile taken in
// 32-key halves (fewer live accumulators). The row term comes from t_in
// (K5: di = rowsum(o . do), a torch reduction) or, with kRowTerm, from a
// first walk over the same key tiles (K4: t = rowsum(dp . p) from fp32 p
// and dp, as the TPU kernel takes it), which also writes it to t_out for
// the dk/dv kernel. The ring of K/V stages runs on across the two walks.
template <int D, bool kRowTerm>
__device__ __forceinline__ void dq_rows(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ m_rows,
                                        const float* __restrict__ l_rows,
                                        const float* __restrict__ t_in,
                                        float* __restrict__ t_out, bf16* __restrict__ dq,
                                        int L, float scale, float scale_log2) {
  using C = RowCfg<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);
  unsigned char* do_s = q_s + C::kRowTile;
  unsigned char* kv_s = do_s + C::kRowTile;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const QueryTile tile(L, C::kRows);
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const bf16* k_head = k + bh * L * D;
  const bf16* v_head = v + bh * L * D;

  copy_rows<D, C::kThreads>(q_s, q + (bh * L + tile.q0) * D, tile.rows, C::kRows);
  copy_rows<D, C::kThreads>(do_s, dout + (bh * L + tile.q0) * D, tile.rows, C::kRows);
  load_kv<D>(kv_s, k_head, v_head, 0);
  cp_async_commit();

  const int r0 = tile.q0 + wg * 64;
  const bool active = r0 < L;
  const int rw = r0 + warp * 16;
  constexpr int kHalf = kKeys / 2;
  float ml[2], inv_l[2], rt[2];  // rows g and g + 8: the row term rt
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t stat = bh * L + min(rw + g + 8 * i, L - 1);
    ml[i] = m_rows[stat] * kLog2e;
    inv_l[i] = 1.f / l_rows[stat];
    if constexpr (!kRowTerm) rt[i] = t_in[stat];
  }
  // the ring step of the dq walk's first tile
  const int s0 = kRowTerm ? tile.n_kt : 0;

  if constexpr (kRowTerm) {
    float tp[2] = {0.f, 0.f};  // this lane's share of rowsum(dp . p)
    for (int kt = 0; kt < tile.n_kt; ++kt) {
      cp_async_wait_all();
      __syncthreads();
      // the next key tile, or after the last the dq walk's first
      load_kv<D>(kv_s + ((kt + 1) & 1) * 2 * C::kKeyTile, k_head, v_head,
                 kt + 1 < tile.n_kt ? kt + 1 : 0);
      cp_async_commit();
      const int k0 = kt * kKeys;
      if (!active || k0 > r0 + 63) continue;
      const uint32_t k_addr = smem_addr(kv_s + (kt & 1) * 2 * C::kKeyTile);
#pragma unroll
      for (int h = 0; h < kKeys / kHalf; ++h) {
        const int kh = k0 + h * kHalf;
        if (kh > r0 + 63) continue;
        float s[kHalf / 8][4] = {}, dp[kHalf / 8][4] = {};
        wg_abt<D, kHalf>(s, smem_addr(q_s), C::kRows, wg * 64, k_addr, kKeys, h * kHalf);
        wg_abt<D, kHalf>(dp, smem_addr(do_s), C::kRows, wg * 64, k_addr + C::kKeyTile,
                         kKeys, h * kHalf);
        const bool diag = kh + kHalf - 1 > rw;
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float p = exp2_ftz(fmaf(s[j][e], scale_log2, -ml[i])) * inv_l[i];
            if (diag && kh + j * 8 + 2 * t + (e & 1) > rw + g + 8 * i) p = 0.f;
            tp[i] = fmaf(p, dp[j][e], tp[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rt[i] = quad_sum(tp[i]);
      if (active && t == 0) t_out[bh * L + rw + g + 8 * i] = rt[i];
    }
  }

  float acc[D / 8][4] = {};
  for (int kt = 0; kt < tile.n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < tile.n_kt)
      load_kv<D>(kv_s + ((s0 + kt + 1) & 1) * 2 * C::kKeyTile, k_head, v_head, kt + 1);
    cp_async_commit();
    const int k0 = kt * kKeys;
    if (!active || k0 > r0 + 63) continue;
    const uint32_t k_addr = smem_addr(kv_s + ((s0 + kt) & 1) * 2 * C::kKeyTile);

#pragma unroll
    for (int h = 0; h < kKeys / kHalf; ++h) {
      const int kh = k0 + h * kHalf;
      if (kh > r0 + 63) continue;  // every key of the half above the rows
      float s[kHalf / 8][4] = {}, dp[kHalf / 8][4] = {};
      wg_abt<D, kHalf>(s, smem_addr(q_s), C::kRows, wg * 64, k_addr, kKeys, h * kHalf);
      wg_abt<D, kHalf>(dp, smem_addr(do_s), C::kRows, wg * 64, k_addr + C::kKeyTile,
                       kKeys, h * kHalf);
      const bool diag = kh + kHalf - 1 > rw;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2_ftz(fmaf(s[j][e], scale_log2, -ml[i])) * inv_l[i];
          if (diag && kh + j * 8 + 2 * t + (e & 1) > rw + g + 8 * i) p = 0.f;
          s[j][e] = (dp[j][e] - rt[i]) * p * scale;  // ds
        }
      }
      uint32_t da[kHalf / 16][4];
      to_a<kHalf>(da, s);
      wg_pb<D, kHalf>(acc, da, k_addr, kKeys, h * kHalf);  // dq += ds . k
    }
  }
  if (!active) return;
  store_rows<D>(dq + (bh * L + rw) * D, acc, lane);
}

// dk and dv of one 64-key tile (one warpgroup; FlashAttention-2's
// arrangement). k and v stay in shared memory; q, do and the rows' m, l
// and row term (t_rows) stream through the ring, kQ query rows a step. It
// computes s^T = k.q^T and dp^T = v.do^T, so p^T and ds^T come out of the
// accumulators already in the A layout of dv += p^T.do and dk += ds^T.q;
// m, l and t are per column there and read from the stage.
template <int D>
__device__ __forceinline__ void dkv_keys(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const bf16* __restrict__ dout,
                                         const float* __restrict__ m_rows,
                                         const float* __restrict__ l_rows,
                                         const float* __restrict__ t_rows,
                                         bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                                         float scale, float scale_log2) {
  using C = DkvCfg<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);
  unsigned char* v_s = k_s + C::kKeyTile;
  unsigned char* stages = v_s + C::kKeyTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.z * kKeys;  // the first key tiles see the most queries
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int n_steps = (L - k0) / C::kQ;

  copy_rows<D, C::kThreads>(k_s, k + (bh * L + k0) * D, kKeys, kKeys);
  copy_rows<D, C::kThreads>(v_s, v + (bh * L + k0) * D, kKeys, kKeys);
  load_q_step<D>(stages, q, dout, m_rows, l_rows, t_rows, bh * L + k0);
  cp_async_commit();

  const int kw = k0 + warp * 16;  // the warp's first key
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};

  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait_all();
    __syncthreads();  // step j is in; the warpgroup is done with step j - 1
    if (j + 1 < n_steps)
      load_q_step<D>(stages + ((j + 1) & 1) * C::kStage, q, dout, m_rows, l_rows,
                     t_rows, bh * L + k0 + (j + 1) * C::kQ);
    cp_async_commit();
    const int q0 = k0 + j * C::kQ;
    unsigned char* stage = stages + (j & 1) * C::kStage;
    const uint32_t q_addr = smem_addr(stage), do_addr = q_addr + C::kQTile;
    const float* stats = reinterpret_cast<const float*>(stage + 2 * C::kQTile);

    // s^T = k . q^T and dp^T = v . do^T: rows are the keys, columns the
    // step's queries
    float st[C::kQ / 8][4] = {}, dpt[C::kQ / 8][4] = {};
    wg_abt<D, C::kQ>(st, smem_addr(k_s), kKeys, 0, q_addr, C::kQ, 0);
    wg_abt<D, C::kQ>(dpt, smem_addr(v_s), kKeys, 0, do_addr, C::kQ, 0);
    const bool diag = q0 < kw + 15;
#pragma unroll
    for (int jn = 0; jn < C::kQ / 8; ++jn) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = jn * 8 + 2 * t + c;  // query within the step
        const float ml = stats[col] * kLog2e;
        const float inv_l = 1.f / stats[C::kQ + col];
        const float rt = stats[2 * C::kQ + col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + c;
          float p = exp2_ftz(fmaf(st[jn][e], scale_log2, -ml)) * inv_l;
          if (diag && q0 + col < kw + g + 8 * i) p = 0.f;
          st[jn][e] = p;
          dpt[jn][e] = (dpt[jn][e] - rt) * p * scale;  // ds^T
        }
      }
    }
    uint32_t pa[C::kQ / 16][4];
    to_a<C::kQ>(pa, st);
    wg_pb<D, C::kQ>(dv_acc, pa, do_addr, C::kQ, 0);  // dv += p^T . do
    to_a<C::kQ>(pa, dpt);
    wg_pb<D, C::kQ>(dk_acc, pa, q_addr, C::kQ, 0);   // dk += ds^T . q
  }
  store_rows<D>(dv + (bh * L + kw) * D, dv_acc, lane);
  store_rows<D>(dk + (bh * L + kw) * D, dk_acc, lane);
}

}  // namespace
