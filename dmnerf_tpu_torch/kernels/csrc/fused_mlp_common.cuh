// Shared pieces of the fused PE + DM-NeRF MLP kernels (fused_mlp_fwd.cuh,
// fused_mlp_bwd.cuh, fused_pe.cu): the tiling, the cp.async / ldmatrix / mma.sync
// primitives, the streamed layer product, the in-kernel positional encoding and the
// row copies between shared and device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmnerf {

constexpr int BM = 128;                  // points per CTA
constexpr int THREADS = 256;             // 8 warps: 2 along M x 4 along N
constexpr int KB = 64;                   // weight rows per pipeline stage
constexpr int N_MAX = 256;               // widest layer output
constexpr int ACT_COLS = 352;            // widest [ed | h | e] row
constexpr int LDA = ACT_COLS + 8;        // padded row pitch (bf16): conflict-free ldmatrix
constexpr int LDB = N_MAX + 8;           // padded stage row pitch (bf16)
constexpr int MAX_LAYERS = 20;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [k0, k0 + kb) of a row-major [K, N] bf16 weight block into shared memory.
__device__ __forceinline__ void load_stage(__nv_bfloat16* dst, const __nv_bfloat16* w, int k0,
                                           int K, int N) {
  const int kb = min(KB, K - k0);
  const int chunks = N / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kb * chunks; c += THREADS) {
    const int r = c / chunks, q = c - r * chunks;
    cp_async16(dst + r * LDB + q * 8, w + (size_t)(k0 + r) * N + q * 8);
  }
}

// acc = act[:, a_col : a_col + K] @ w for a CTA's BM rows: act is [BM][lda] bf16 in
// shared memory, w a row-major [K, N] bf16 block in device memory, streamed through
// `stage` in KB-row slices (double-buffered cp.async). The 8 warps tile the [BM, N]
// output as 2 x 4 warp tiles of 64 x 64. Ends with a barrier: every warp is done
// with act and stage.
__device__ __forceinline__ void tile_product(float (&acc)[4][8][4], const __nv_bfloat16* act,
                                             int lda, int a_col, const __nv_bfloat16* w, int K,
                                             int N, __nv_bfloat16* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int n_slices = (K + KB - 1) / KB;
  load_stage(stage, w, 0, K, N);
  cp_async_commit();
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      load_stage(stage + ((s + 1) & 1) * KB * LDB, w, (s + 1) * KB, K, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* bs = stage + (s & 1) * KB * LDB;
    const int kb = min(KB, K - s * KB);
    for (int kk = 0; kk < kb; kk += 16) {
      uint32_t bfrag[8][2];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int n0 = wn * 64 + jp * 16;
        if (n0 < N) {
          const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = n0 + (lane >> 4) * 8;
          ldmatrix_x4_trans(bfrag[2 * jp][0], bfrag[2 * jp][1], bfrag[2 * jp + 1][0],
                            bfrag[2 * jp + 1][1], bs + k * LDB + n);
        }
      }
      if (wn * 64 >= N) continue;  // this warp's columns are all padding
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        const int row = wm * 64 + i * 16 + (lane & 15);
        ldmatrix_x4(a, act + row * lda + a_col + s * KB + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (wn * 64 + j * 8 < N) mma_bf16(acc[i][j], a, bfrag[j]);
      }
    }
    __syncthreads();
  }
}

// The embedding [x | sin(2^f x) | cos(2^f x) | 0 pad] of rows p0 .. p0 + BM of a
// row-major [P, 3] fp32 array, rounded to bf16 into columns [0, width) of the rows
// at dst (pitch ld). Lane f*3+c of each half holds channel c at octave f. The phase
// x * 2^f is exact and sincosf is the accurate one (no fast math): the phases reach
// 2^9 * |x| (thousands of radians), where a rounded phase is an O(1) error. Rows past
// P get the embedding of 0.
__device__ __forceinline__ void embed_rows(__nv_bfloat16* dst, const float* __restrict__ x,
                                           long long p0, long long P, int multires, int width,
                                           int ld = LDA) {
  const int nf = 3 * multires;
  for (int c = threadIdx.x; c < BM * nf; c += THREADS) {
    const int r = c / nf, j = c - r * nf;
    const int f = j / 3, ch = j - 3 * f;
    const long long p = p0 + r;
    const float v = p < P ? x[p * 3 + ch] : 0.f;
    float s, co;
    sincosf(v * (float)(1u << f), &s, &co);
    dst[r * ld + 3 + j] = __float2bfloat16(s);
    dst[r * ld + 3 + nf + j] = __float2bfloat16(co);
  }
  const int tail = width - 3 - 2 * nf;  // identity columns + zero padding
  for (int c = threadIdx.x; c < BM * (3 + tail); c += THREADS) {
    const int r = c / (3 + tail), j = c - r * (3 + tail);
    const long long p = p0 + r;
    float v = 0.f;
    if (j < 3 && p < P) v = x[p * 3 + j];
    dst[r * ld + (j < 3 ? j : 2 * nf + j)] = __float2bfloat16(v);
  }
}

// Columns [0, width) of the CTA's rows from a per-ray bf16 table [P / S, width]:
// point p reads row p / S (S = 1: a per-point table). Rows past P are zero.
__device__ __forceinline__ void copy_ray_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ table,
                                              long long p0, long long P, int S, int width) {
  const int chunks = width / 8;
  for (int c = threadIdx.x; c < BM * chunks; c += THREADS) {
    const int r = c / chunks, q = c - r * chunks;
    const long long p = p0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < P) v = *reinterpret_cast<const uint4*>(table + (p / S) * width + q * 8);
    *reinterpret_cast<uint4*>(dst + r * LDA + q * 8) = v;
  }
}

// Copy columns [col0, col0 + n) of the CTA's shared-memory rows (pitch lds) to rows
// p0 .. of a row-major [P, n] bf16 array in device memory; rows past P are not stored.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int lds,
                                           int col0, int n, long long p0, long long P) {
  const int chunks = n / 8;
  for (int c = threadIdx.x; c < BM * chunks; c += THREADS) {
    const int r = c / chunks, q = c - r * chunks;
    const long long p = p0 + r;
    if (p < P)
      *reinterpret_cast<uint4*>(dst + p * n + q * 8) =
          *reinterpret_cast<const uint4*>(src + r * lds + col0 + q * 8);
  }
}

// Where the [ed | h | e] rows of a CTA come from, one value per kernel pair:
//  ROWS_RAY_TABLE   K1 / K2: `pt_src` the points [P, 3] fp32, embedded in the kernel;
//                   `ed_src` the per-ray viewdir embedding [P / S, h_col] bf16.
//  ROWS_POINT_DIRS  K3 / K4: `pt_src` the points, `ed_src` each point's own direction
//                   [P, 3] fp32; both embedded in the kernel.
//  ROWS_EMBEDDED    K5 / K6: `pt_src` the point embedding e [P, e_width] and `ed_src`
//                   the per-point viewdir embedding [P, h_col], both bf16, built before
//                   the launch (e by K7, fused_pe.cu); S is 1.
enum Rows { ROWS_RAY_TABLE = 0, ROWS_POINT_DIRS = 1, ROWS_EMBEDDED = 2 };

// The [ed | h | e] rows of a CTA before its first layer (h is left as it is): the
// viewdir embedding in columns [0, h_col), the point embedding in [e_col, e_col +
// e_width), filled as ROWS says.
template <Rows ROWS>
__device__ __forceinline__ void build_rows(__nv_bfloat16* act, const void* pt_src,
                                           const void* ed_src, long long p0, long long P, int S,
                                           int multires, int multires_views, int h_col,
                                           int e_col, int e_width) {
  if (ROWS == ROWS_POINT_DIRS)
    embed_rows(act, static_cast<const float*>(ed_src), p0, P, multires_views, h_col);
  else
    copy_ray_rows(act, static_cast<const __nv_bfloat16*>(ed_src), p0, P, S, h_col);
  if (ROWS == ROWS_EMBEDDED)
    copy_ray_rows(act + e_col, static_cast<const __nv_bfloat16*>(pt_src), p0, P, 1, e_width);
  else
    embed_rows(act + e_col, static_cast<const float*>(pt_src), p0, P, multires, e_width);
}

}  // namespace dmnerf
