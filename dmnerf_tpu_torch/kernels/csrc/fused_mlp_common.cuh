// Shared pieces of the fused PE + DM-NeRF MLP kernels (fused_mlp_fwd.cuh,
// fused_mlp_bwd.cuh): the tiling, the in-kernel positional encoding (whose
// bits K7, fused_pe.cu, builds too) and the 128-byte swizzle of the forward's embedding
// tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmnerf {

constexpr int BM = 128;                  // points per tile
constexpr int THREADS = 256;             // threads of the reductions
constexpr int N_MAX = 256;               // widest layer output
constexpr int MAX_LAYERS = 20;

// Element (r, c) of a [rows][64] bf16 tile with 128-byte swizzle, as TMA writes it
// and wgmma reads it (the 16-byte chunk index XOR the row index mod 8; the tile sits on
// a 1024-byte boundary).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// The embedding [x | sin(2^f x) | cos(2^f x) | 0 pad] of rows p0 .. p0 + BM of a
// row-major [P, 3] fp32 array, rounded to bf16 into columns [0, width) of the rows
// at dst (pitch ld; with SW128 a swizzled [BM][64] tile, width 64). Lane f*3+c of
// each half holds channel c at octave f. The phase x * 2^f is exact and sincosf is the
// accurate one (no fast math): the phases reach 2^9 * |x| (thousands of radians),
// where a rounded phase is an O(1) error. Rows past P get the embedding of 0. Threads
// tid of nthr share the work.
template <bool SW128 = false>
__device__ __forceinline__ void embed_rows(__nv_bfloat16* dst, const float* __restrict__ x,
                                           long long p0, long long P, int multires, int width,
                                           int ld, int tid = threadIdx.x,
                                           int nthr = THREADS) {
  const int nf = 3 * multires;
  for (int c = tid; c < BM * nf; c += nthr) {
    const int r = c / nf, j = c - r * nf;
    const int f = j / 3, ch = j - 3 * f;
    const long long p = p0 + r;
    const float v = p < P ? x[p * 3 + ch] : 0.f;
    float s, co;
    sincosf(v * (float)(1u << f), &s, &co);
    dst[SW128 ? sw128(r, 3 + j) : r * ld + 3 + j] = __float2bfloat16(s);
    dst[SW128 ? sw128(r, 3 + nf + j) : r * ld + 3 + nf + j] = __float2bfloat16(co);
  }
  const int tail = width - 3 - 2 * nf;  // identity columns + zero padding
  for (int c = tid; c < BM * (3 + tail); c += nthr) {
    const int r = c / (3 + tail), j = c - r * (3 + tail);
    const long long p = p0 + r;
    float v = 0.f;
    if (j < 3 && p < P) v = x[p * 3 + j];
    const int col = j < 3 ? j : 2 * nf + j;
    dst[SW128 ? sw128(r, col) : r * ld + col] = __float2bfloat16(v);
  }
}

// Where a forward tile's embeddings come from, one value per kernel pair:
//  ROWS_RAY_TABLE   K1 / K2: `pt_src` the points [P, 3] fp32, embedded in the kernel;
//                   `ed_src` the per-ray viewdir embedding [P / S, EDP] bf16.
//  ROWS_POINT_DIRS  K3 / K4: `pt_src` the points, `ed_src` each point's own direction
//                   [P, 3] fp32; both embedded in the kernel.
//  ROWS_EMBEDDED    K5 / K6: `pt_src` the point embedding e [P, EP] and `ed_src` the
//                   per-point viewdir embedding [P, EDP], both bf16, built before the
//                   launch (e by K7, fused_pe.cu); S is 1.
//  ROWS_RAY_Z       K8 (fused_render.cu): the rays' origins and directions [N, 3] and
//                   depths z [N, S] fp32; the embedding warps form the points o + d z
//                   and embed them; `ed_src` as ROWS_RAY_TABLE.
//  ROWS_H           K9, K10 (head512.cu, heads_fused.cu): no embedding; `pt_src` a hidden
//                   activation x [P, 256] bf16 that the consumers take into registers, and
//                   an optional transposed viewdir embedding edT [E, P] bf16.
enum Rows { ROWS_RAY_TABLE = 0, ROWS_POINT_DIRS = 1, ROWS_EMBEDDED = 2, ROWS_RAY_Z = 3,
            ROWS_H = 4 };

}  // namespace dmnerf
