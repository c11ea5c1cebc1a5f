// Parameter backward of the fused positional encoding + DM-NeRF MLP point query,
// sm_90a: the kernels and the launch sequence behind three entry points.
//
//  * fused_mlp_bwd.cu (K2) replaces the JAX package's Pallas TPU kernel
//    _bwd_kernel_pet (dmnerf_tpu/kernels/fused_mlp.py:520), pe_mode 'kernel_t'.
//  * fused_mlp_bwd_kpe.cu (K4) replaces _bwd_kernel (:481), pe_mode 'kernel'.
//  * fused_mlp_bwd_pe.cu (K6) replaces _bwd_kernel_pe (:494), pe_mode 'outside'.
// All three carry _backward_core (:536) and _accumulate_grads (:653). What they
// compute is set out in dmnerf_tpu_torch/kernels/fused_mlp.py, whose
// fused_query_bwd_ref / fused_query_kpe_bwd_ref / fused_query_pe_bwd_ref are their
// plain versions and whose _bwd_plan builds the tables they read. Numerics follow the
// JAX package: bf16 operands for every product (activations, cotangents cast once,
// weights), fp32 accumulation, and bias gradients summed from the fp32 cotangents.
// Nothing flows into the points, the directions or the embeddings (the JAX package
// returns zeros for them).
//
// The forward of the same query writes the stash these kernels read: the training
// forward is fused_mlp_fwd.cuh's kernel with STASH (every ReLU output, and the point
// and per-point viewdir embeddings for K2 and K4), so nothing is rematerialised here.
// The TPU kernel rematerialises per tile because its 16 GB could not hold the
// activations; the stash is about 4.8 KB a flagship point, 2.8 GB for 589,824 fine
// points, on an 80 GB card. The three kernel pairs differ only in that forward's
// prologue and in where the dW jobs find the embeddings (K6 reads its inputs e and
// ed), which is table data: the code below is the same for all three.
//
// Bound. Per flagship point (D=8, W=256, ins_num 32) the backward's own products
// are dW, the forward's 564,864 multiply-accumulates, and dX into the trunk,
// 7 * 256^2 + 256 * 129 + 128 * 36 = 496,384: 2.12 MFLOP, so the operations bound is
// 1.27 ms for the fine training query at the 989 TFLOP/s bf16 peak. The design moves
// the stash (read twice) and the bf16 cotangents (written once, read once), ≈ 11 GB
// for the fine query, ≈ 3.3 ms at 3.35 TB/s: it is bound by bytes.
//
// Design: four launches in a fixed order with no atomics, so the same inputs give
// bit-identical gradients.
//  1. bwd_data_kernel: a persistent grid, one CTA per SM walking 128-point tiles. One
//     producer thread keeps TMA loads of weight boxes (64 output columns x 256 input
//     rows, read in the blocks' stored [in, out] layout, which is wgmma's K-major B
//     for dX = G W^T) in flight through a 4-stage mbarrier ring. Two consumer
//     warpgroups each own 64 points and run wgmma m64n256k16 with A from registers:
//     the previous layer's fp32 accumulator, masked by the stashed ReLU output and
//     cast to bf16, is exactly the next product's A fragment, so a cotangent never
//     goes through shared memory. The ReLU mask is the layer's stash tile, copied into
//     shared memory with cp.async while the product runs. Each layer's masked
//     cotangent is also written bf16 to device memory for dW, and its fp32 column sums
//     reduced over the tile in a fixed order into a per-tile bias partial. The walk is
//     bound by those stash reads and cotangent writes, which the epilogue issues
//     between products: the tensor cores wait for them. The head step reads two
//     weight blocks as two K-chunks: the head's h rows x rgb-hidden columns, then the
//     sigma block, whose A fragment takes the place of the first instance columns;
//     the instance head's cotangent reaches dW but never the trunk (its detach), and
//     nothing reaches ed.
//  2. dw_kernel: dW_l = A_l^T d_pre_l with the points as the reduction dimension, one
//     job per (layer, A segment): A is a stash segment or an input embedding, both
//     [point][feature] rows, so A and B are MN-major wgmma operands. A CTA owns 128
//     features x 256 columns of one job over a fixed range of points; a producer
//     thread streams 64-point TMA boxes (128-byte swizzle) of A and d_pre through a
//     4-stage ring, two consumer warpgroups run wgmma m64n256k16 from shared memory,
//     and the fp32 partial tile is written for the range. CTAs of one point range
//     are launched next to each other, so their shared reads of d_pre hit in L2.
//  3., 4. sum_rows_kernel on the dW and on the bias partials: fixed-order sums over
//     the point ranges and over the tiles.
#pragma once

#include "fused_mlp_common.cuh"
#include "fused_mlp_sm90.cuh"

namespace {

using namespace dmnerf;
using namespace sm90;

constexpr int WG = 128;                    // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;          // two consumer warpgroups
constexpr int BW_THREADS = CONSUMERS + WG; // and the producer warpgroup
constexpr int PT = 128;                    // points per bwd_data tile (64 a warpgroup)
constexpr int WBOX_K = 64, WBOX_N = 256;   // weight box: 64 output columns x 256 input rows
constexpr uint32_t WBOX_BYTES = WBOX_K * WBOX_N * 2;
constexpr int W_STAGES = 4;
constexpr int KP = 64;                     // dW: points per stage
constexpr uint32_t DBOX_BYTES = 64 * KP * 2;  // a 64-column x KP-point box
constexpr int DW_STAGES = 4;
constexpr int DW_STAGE_BOXES = 6;          // 2 A boxes (128 features) + 4 B boxes (256 columns)
constexpr int SIG_N = 16;                  // width of the sigma layer
constexpr int MAX_WMAPS = MAX_LAYERS + 2;
constexpr int MAX_CHUNKS = 4 * MAX_LAYERS + 8;
constexpr int MAX_DMAPS = 3 * MAX_LAYERS + 4;
constexpr int MAX_JOBS = 2 * MAX_LAYERS + 2;

constexpr int LDM = N_MAX + 8;             // pitch of the ReLU-mask tile (conflict-free reads)
constexpr size_t BWD_DBS = (size_t)2 * 8 * N_MAX * 4 + (size_t)2 * 8 * 4;
constexpr size_t BWD_SMEM = 1024 + (size_t)W_STAGES * WBOX_BYTES + BWD_DBS + (size_t)PT * LDM * 2 +
                            (size_t)2 * W_STAGES * 8;
constexpr size_t DW_SMEM =
    1024 + (size_t)DW_STAGES * DW_STAGE_BOXES * DBOX_BYTES + (size_t)2 * DW_STAGES * 8;

// A weight box of a backward-data step: map `map` at output column k0 feeds the A
// fragments a0 .. a0 + n16 (16 columns each) of the step's product.
struct WChunk {
  int map, k0, a0, n16;
};

// A backward-data step: its product's chunks, and the layer it writes (N columns,
// bias at b_off, ReLU mask and cotangent blocks of pitch N).
struct BStep {
  int N, chunk0, n_chunks, b_off;
  long long mask_off, dpre_off;
};

struct BwdParams {
  CUtensorMap wmaps[MAX_WMAPS];
  BStep steps[MAX_LAYERS];
  WChunk chunks[MAX_CHUNKS];
  long long P, dpre_out, dpre_sigma;
  int n_steps, n_tiles, c4, no, hr, total_b, b_out, b_sigma;
};

// A dW job: dW rows [k_off, k_off + width) of the layer block at w_off (N columns)
// from the segment map `amap` [P, width] and the cotangent map `bmap` [P, N].
struct DwJob {
  int amap, bmap, width, N, k_off, f_tiles, tile0;
  long long w_off;
};

struct DwParams {
  CUtensorMap maps[MAX_DMAPS];
  DwJob jobs[MAX_JOBS];
  long long P, chunk, total_w;
  int n_jobs, n_tiles;
};

struct Ranges {
  int n;
  long long off[MAX_LAYERS], size[MAX_LAYERS];
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- launch 1: the cotangent of every layer, walking the table in reverse ----
__global__ void __launch_bounds__(BW_THREADS, 1)
bwd_data_kernel(const __grid_constant__ BwdParams p, const float* __restrict__ gout,
                const __nv_bfloat16* __restrict__ stash, __nv_bfloat16* __restrict__ dpre,
                float* __restrict__ dbpart) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);          // [stage][256][64]
  float* dbs = reinterpret_cast<float*>(smem + W_STAGES * WBOX_BYTES);   // [2][8 warps][N_MAX]
  float* sigs = dbs + 2 * 8 * N_MAX;                                      // [2][8 warps]
  __nv_bfloat16* mtile = reinterpret_cast<__nv_bfloat16*>(smem + W_STAGES * WBOX_BYTES + BWD_DBS);
  uint64_t* full = reinterpret_cast<uint64_t*>(mtile + PT * LDM);          // [PT][LDM]
  uint64_t* empty = full + W_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: the weight boxes of every step of every tile, in order ----
    regs_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int s = 0; s < p.n_steps; ++s) {
          for (int c = 0; c < p.steps[s].n_chunks; ++c) {
            const WChunk ch = p.chunks[p.steps[s].chunk0 + c];
            mbar_wait(&empty[stage], ph ^ 1);
            mbar_expect_tx(&full[stage], WBOX_BYTES);
            tma_load_2d(wbuf + stage * WBOX_N * WBOX_K, &p.wmaps[ch.map], &full[stage], ch.k0, 0);
            if (++stage == W_STAGES) {
              stage = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns points [64 wg, 64 wg + 64) of each tile ----
    regs_inc<240>();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long P = p.P;
    int stage = 0, par = 0;
    uint32_t ph = 0;
    float acc[128];
    uint32_t af[16][4];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const long long p0 = (long long)tile * PT;
      const long long r0 = p0 + (tid >> 7) * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
      const bool v0 = r0 < P, v1 = r1 < P;
      float* dbrow = dbpart + (long long)tile * p.total_b;

      // out layer: d_pre = g with sigma's column 3 and the padding zeroed, cast to
      // bf16 once; it is the first product's A and the out layer's dW cotangent
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        if (ks * 16 < p.no) {
          float x[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int col = ks * 16 + 2 * t + (q >> 2) * 8 + (q & 1);
            const long long r = (q & 2) ? r1 : r0;
            x[q] = (r < P && col < p.c4 && col != 3) ? gout[r * p.c4 + col] : 0.f;
          }
          af[ks][0] = bf16x2_bits(x[0], x[1]);
          af[ks][1] = bf16x2_bits(x[2], x[3]);
          af[ks][2] = bf16x2_bits(x[4], x[5]);
          af[ks][3] = bf16x2_bits(x[6], x[7]);
          const int col = ks * 16 + 2 * t;
          float cs[4] = {x[0] + x[2], x[1] + x[3], x[4] + x[6], x[5] + x[7]};
#pragma unroll
          for (int m = 4; m < 32; m <<= 1)
#pragma unroll
            for (int v = 0; v < 4; ++v) cs[v] += __shfl_xor_sync(0xffffffffu, cs[v], m);
          if (g == 0) {
            float* dbw = dbs + (par * 8 + warp) * N_MAX + col;
            dbw[0] = cs[0];
            dbw[1] = cs[1];
            dbw[8] = cs[2];
            dbw[9] = cs[3];
          }
          if (v0) {
            *reinterpret_cast<uint32_t*>(dpre + p.dpre_out + r0 * p.no + col) = af[ks][0];
            *reinterpret_cast<uint32_t*>(dpre + p.dpre_out + r0 * p.no + col + 8) = af[ks][2];
          }
          if (v1) {
            *reinterpret_cast<uint32_t*>(dpre + p.dpre_out + r1 * p.no + col) = af[ks][1];
            *reinterpret_cast<uint32_t*>(dpre + p.dpre_out + r1 * p.no + col + 8) = af[ks][3];
          }
        }
      }
      // sigma layer: d_pre = [g_sigma | 0], bf16 once; its A fragment enters the head
      // step in place of the first instance columns
      const float gs0 = v0 ? gout[r0 * p.c4 + 3] : 0.f, gs1 = v1 ? gout[r1 * p.c4 + 3] : 0.f;
      uint32_t sf[4] = {t == 0 ? bf16x2_bits(gs0, 0.f) : 0u, t == 0 ? bf16x2_bits(gs1, 0.f) : 0u,
                        0u, 0u};
      if (t == 0) {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        if (v0) {
          uint4* row = reinterpret_cast<uint4*>(dpre + p.dpre_sigma + r0 * SIG_N);
          row[0] = make_uint4(sf[0], 0u, 0u, 0u);
          row[1] = z;
        }
        if (v1) {
          uint4* row = reinterpret_cast<uint4*>(dpre + p.dpre_sigma + r1 * SIG_N);
          row[0] = make_uint4(sf[1], 0u, 0u, 0u);
          row[1] = z;
        }
      }
      // their bias sums from the fp32 g: over the warp's rows by shuffles (above), then
      // over the 8 warps in order
      float ss = t == 0 ? gs0 + gs1 : 0.f;
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
      if (lane == 0) sigs[par * 8 + warp] = ss;
      bar_sync(1, CONSUMERS);
      if (tid < p.no) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += dbs[(par * 8 + w) * N_MAX + tid];
        dbrow[p.b_out + tid] = sum;
      }
      if (tid < SIG_N) {
        float sum = 0.f;
        if (tid == 0)
#pragma unroll
          for (int w = 0; w < 8; ++w) sum += sigs[par * 8 + w];
        dbrow[p.b_sigma + tid] = sum;
      }
      par ^= 1;

      for (int s = 0; s < p.n_steps; ++s) {
        const BStep st = p.steps[s];
        if (s == 1) {
          const int hs = p.hr >> 4;
#pragma unroll
          for (int ks = 0; ks < 16; ++ks)
            if (ks == hs) {
#pragma unroll
              for (int v = 0; v < 4; ++v) af[ks][v] = sf[v];
            }
        }
        // the ReLU mask of the layer this step writes, [PT][N] from the stash, copied
        // into shared memory while the product runs
        {
          const __nv_bfloat16* src = stash + st.mask_off;
          const int chunks = st.N / 8;
          for (int c = tid; c < PT * chunks; c += CONSUMERS) {
            const int r = c / chunks, q = c - r * chunks;
            if (p0 + r < P) cp_async16(mtile + r * LDM + q * 8, src + (p0 + r) * st.N + q * 8);
          }
          cp_async_commit();
        }
        // dX = G W^T chunk by chunk, the weight boxes from the ring
        for (int c = 0; c < st.n_chunks; ++c) {
          const WChunk ch = p.chunks[st.chunk0 + c];
          mbar_wait(&full[stage], ph);
          const uint64_t db = desc_sw128(wbuf + stage * WBOX_N * WBOX_K, 16, 1024);
          fence_regs(acc);
          fence_regs(af);
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < 16; ++ks)
            if (ks >= ch.a0 && ks < ch.a0 + ch.n16)
              wgmma_rs_n256(acc, af[ks], db + (uint64_t)(2 * (ks - ch.a0)),
                            (c > 0 || ks > ch.a0) ? 1 : 0);
          wg_commit();
          wg_wait<0>();
          fence_regs(acc);
          fence_regs(af);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == W_STAGES) {
            stage = 0;
            ph ^= 1;
          }
        }
        // epilogue: mask by the stashed ReLU output, write d_pre bf16, keep it as the
        // next product's A fragments, and sum the fp32 columns over the warp's rows
        cp_async_wait<0>();
        bar_sync(1, CONSUMERS);
        const int lr0 = (int)(r0 - p0);
        __nv_bfloat16* dp = dpre + st.dpre_off;
        float* dbw = dbs + (par * 8 + warp) * N_MAX;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = j * 8 + 2 * t;
          float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
          uint32_t h0 = 0u, h1 = 0u;
          if (col < st.N) {
            if (v0) {
              const __nv_bfloat162 m =
                  *reinterpret_cast<const __nv_bfloat162*>(mtile + lr0 * LDM + col);
              x0 = __bfloat162float(m.x) > 0.f ? acc[4 * j] : 0.f;
              x1 = __bfloat162float(m.y) > 0.f ? acc[4 * j + 1] : 0.f;
            }
            if (v1) {
              const __nv_bfloat162 m =
                  *reinterpret_cast<const __nv_bfloat162*>(mtile + (lr0 + 8) * LDM + col);
              x2 = __bfloat162float(m.x) > 0.f ? acc[4 * j + 2] : 0.f;
              x3 = __bfloat162float(m.y) > 0.f ? acc[4 * j + 3] : 0.f;
            }
            h0 = bf16x2_bits(x0, x1);
            h1 = bf16x2_bits(x2, x3);
            if (v0) *reinterpret_cast<uint32_t*>(dp + r0 * st.N + col) = h0;
            if (v1) *reinterpret_cast<uint32_t*>(dp + r1 * st.N + col) = h1;
          }
          af[j >> 1][(j & 1) * 2] = h0;
          af[j >> 1][(j & 1) * 2 + 1] = h1;
          float s0 = x0 + x2, s1 = x1 + x3;
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, m);
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
          }
          if (g == 0 && col < st.N) {
            dbw[col] = s0;
            dbw[col + 1] = s1;
          }
        }
        // the 8 warps' sums in order; dbs alternates, so one barrier a use suffices, and
        // it also ends every read of the mask tile before the next step refills it
        bar_sync(1, CONSUMERS);
        if (tid < st.N) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) sum += dbs[(par * 8 + w) * N_MAX + tid];
          dbrow[st.b_off + tid] = sum;
        }
        par ^= 1;
      }
    }
  }
}

// ---- launch 2: dW partials, split over the point axis ----
__global__ void __launch_bounds__(BW_THREADS, 1)
dw_kernel(const __grid_constant__ DwParams p, float* __restrict__ dwpart) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // stage s: boxes [A feature block 0, A feature block 1, B column block 0..3], each
  // [KP points][64] bf16 with 128-byte swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BOXES * DBOX_BYTES);
  uint64_t* empty = full + DW_STAGES;

  const int tile = blockIdx.x % p.n_tiles;
  const long long chunk = blockIdx.x / p.n_tiles;
  int jb = 0;
  while (jb + 1 < p.n_jobs && tile >= p.jobs[jb + 1].tile0) ++jb;
  const DwJob job = p.jobs[jb];
  const int f0 = (tile - job.tile0) * 128;
  const long long pbeg = chunk * p.chunk;
  const long long pend = min(p.P, pbeg + p.chunk);
  const int n_st = (int)((pend - pbeg + KP - 1) / KP);
  const int nb = (job.N + 63) / 64;
  const bool a1 = f0 + 64 < job.width;   // the second feature block holds features

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    regs_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      const uint32_t bytes = (uint32_t)((a1 ? 2 : 1) + nb) * DBOX_BYTES;
      int stage = 0;
      uint32_t ph = 0;
      for (int st = 0; st < n_st; ++st) {
        const int pr = (int)(pbeg + (long long)st * KP);
        unsigned char* base = smem + stage * DW_STAGE_BOXES * DBOX_BYTES;
        mbar_wait(&empty[stage], ph ^ 1);
        mbar_expect_tx(&full[stage], bytes);
        tma_load_2d(base, &p.maps[job.amap], &full[stage], f0, pr);
        if (a1) tma_load_2d(base + DBOX_BYTES, &p.maps[job.amap], &full[stage], f0 + 64, pr);
        for (int i = 0; i < nb; ++i)
          tma_load_2d(base + (2 + i) * DBOX_BYTES, &p.maps[job.bmap], &full[stage], 64 * i, pr);
        if (++stage == DW_STAGES) {
          stage = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    regs_inc<240>();
    const int tid = threadIdx.x, wgi = tid >> 7, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool live = wgi == 0 || a1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t ph = 0;
    for (int st = 0; st < n_st; ++st) {
      mbar_wait(&full[stage], ph);
      if (live) {
        const unsigned char* base = smem + stage * DW_STAGE_BOXES * DBOX_BYTES;
        const uint64_t da = desc_sw128(base + wgi * DBOX_BYTES, DBOX_BYTES, 1024);
        const uint64_t db = desc_sw128(base + 2 * DBOX_BYTES, DBOX_BYTES, 1024);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KP / 16; ++ks)   // 16 points (16 rows of 128 bytes) a step
          wgmma_ss_n256_tt(acc, da + (uint64_t)(ks * 128), db + (uint64_t)(ks * 128),
                           (st > 0 || ks > 0) ? 1 : 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == DW_STAGES) {
        stage = 0;
        ph ^= 1;
      }
    }
    if (!live) return;
    float* out = dwpart + chunk * p.total_w + job.w_off;
    const int fr0 = f0 + wgi * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = j * 8 + 2 * t;
      if (n >= job.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = fr0 + half * 8;
        if (f < job.width)
          *reinterpret_cast<float2*>(out + (long long)(job.k_off + f) * job.N + n) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ---- launches 3 and 4: out[c] = sum_r part[r][c], r in a fixed order ----
// A CTA takes 32 columns; its 8 warps sum strided rows, then warp 0 adds the 8
// partial sums in order. With ranges (dW), columns outside every layer's block are
// alignment padding and are written as 0.
__global__ void __launch_bounds__(THREADS)
sum_rows_kernel(const float* __restrict__ part, long long R, long long C, float* __restrict__ out,
                const Ranges ranges) {
  __shared__ float sums[THREADS / 32][32];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + cx;
  bool inside = c < C;
  if (inside && ranges.n > 0) {
    inside = false;
    for (int l = 0; l < ranges.n; ++l)
      if (c >= ranges.off[l] && c < ranges.off[l] + ranges.size[l]) inside = true;
  }
  float s = 0.f;
  if (inside)
    for (long long r = ry; r < R; r += THREADS / 32) s += part[r * C + c];
  sums[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) t += sums[k][cx];
    out[c] = t;
  }
}

// Launch the four kernels on `stream`; returns 0 when every launch was accepted, a
// cudaError, or 10000 + a CUresult of the tensor-map encoder. `stash` is what the
// training forward wrote; `e_in`, `ed_in` are K6's input embeddings (segment sources
// 2 and 1; unused by K2 and K4). `table` is the int64 table of fused_mlp.py's
// _bwd_plan:
//   header   P, c4, no, hr, total_b, total_w, b_out, b_sigma, dpre_out, dpre_sigma,
//            n_chunks, chunk, n_wmaps, n_steps, n_wchunks, n_dmaps, n_jobs, n_ranges
//   n_wmaps  rows w_off, cols, rows               (weight blocks, [rows, cols] pitch cols)
//   n_steps  rows N, chunk0, n_chunks, b_off, mask_off, dpre_off
//   n_wchunks rows map, k0, a0, n16
//   n_dmaps  rows src, off, width                 (src 0 stash, 1 ed_in, 2 e_in, 3 d_pre)
//   n_jobs   rows amap, bmap, width, N, k_off, w_off
//   n_ranges rows w_off, size                     (each layer's dW block)
inline int run_fused_mlp_bwd(const void* e_in, const void* ed_in, const void* weights,
                             const float* g, const void* stash, void* dpre, float* dbpart,
                             float* dwpart, float* dw, float* db, const long long* table,
                             int n_sms, void* stream) {
  const long long* h = table;
  const long long P = h[0];
  const int n_wmaps = (int)h[12], n_steps = (int)h[13], n_wchunks = (int)h[14];
  const int n_dmaps = (int)h[15], n_jobs = (int)h[16], n_ranges = (int)h[17];
  if (P <= 0 || n_sms <= 0 || n_wmaps < 3 || n_wmaps > MAX_WMAPS || n_steps < 2 ||
      n_steps > MAX_LAYERS || n_wchunks < 1 || n_wchunks > MAX_CHUNKS || n_dmaps < 1 ||
      n_dmaps > MAX_DMAPS || n_jobs < 1 || n_jobs > MAX_JOBS || n_ranges < 1 ||
      n_ranges > MAX_LAYERS || h[2] > N_MAX || h[3] % 16 || h[3] > 3 * WBOX_K)
    return (int)cudaErrorInvalidValue;
  const long long total_b = h[4], total_w = h[5], n_chunks = h[10];
  const long long* row = table + 18;
  const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(weights);
  int err;
  // the encoder is a driver-API call and needs the device's context current on this
  // thread, which a thread that has only launched kernels (autograd's) may not have
  cudaPointerAttributes attr;
  cudaError_t e;
  if ((e = cudaPointerGetAttributes(&attr, weights)) != cudaSuccess ||
      (e = cudaSetDevice(attr.device)) != cudaSuccess)
    return (int)e;

  static BwdParams bp;
  bp.P = P;
  bp.c4 = (int)h[1];
  bp.no = (int)h[2];
  bp.hr = (int)h[3];
  bp.total_b = (int)total_b;
  bp.b_out = (int)h[6];
  bp.b_sigma = (int)h[7];
  bp.dpre_out = h[8];
  bp.dpre_sigma = h[9];
  bp.n_steps = n_steps;
  bp.n_tiles = (int)((P + PT - 1) / PT);
  for (int i = 0; i < n_wmaps; ++i, row += 3)
    if ((err = encode_map(&bp.wmaps[i], wb + row[0], row[1], row[2], row[1], WBOX_K, WBOX_N)))
      return err;
  for (int s = 0; s < n_steps; ++s, row += 6)
    bp.steps[s] = BStep{(int)row[0], (int)row[1], (int)row[2], (int)row[3], row[4], row[5]};
  for (int c = 0; c < n_wchunks; ++c, row += 4)
    bp.chunks[c] = WChunk{(int)row[0], (int)row[1], (int)row[2], (int)row[3]};
  for (int s = 0; s < n_steps; ++s)
    if (bp.steps[s].N > N_MAX || bp.steps[s].chunk0 + bp.steps[s].n_chunks > n_wchunks)
      return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_wchunks; ++c)
    if (bp.chunks[c].map >= n_wmaps || bp.chunks[c].a0 + bp.chunks[c].n16 > 16 ||
        bp.chunks[c].n16 > 4)
      return (int)cudaErrorInvalidValue;

  static DwParams dp;
  dp.P = P;
  dp.chunk = h[11];
  dp.total_w = total_w;
  dp.n_jobs = n_jobs;
  const __nv_bfloat16* srcs[4] = {reinterpret_cast<const __nv_bfloat16*>(stash),
                                  reinterpret_cast<const __nv_bfloat16*>(ed_in),
                                  reinterpret_cast<const __nv_bfloat16*>(e_in),
                                  reinterpret_cast<const __nv_bfloat16*>(dpre)};
  for (int i = 0; i < n_dmaps; ++i, row += 3) {
    if (row[0] < 0 || row[0] > 3 || srcs[row[0]] == nullptr) return (int)cudaErrorInvalidValue;
    if ((err = encode_map(&dp.maps[i], srcs[row[0]] + row[1], row[2], P, row[2], 64, KP)))
      return err;
  }
  int tiles = 0;
  for (int j = 0; j < n_jobs; ++j, row += 6) {
    DwJob& J = dp.jobs[j];
    J.amap = (int)row[0];
    J.bmap = (int)row[1];
    J.width = (int)row[2];
    J.N = (int)row[3];
    J.k_off = (int)row[4];
    J.w_off = row[5];
    if (J.amap >= n_dmaps || J.bmap >= n_dmaps || J.N > N_MAX || J.width <= 0)
      return (int)cudaErrorInvalidValue;
    J.f_tiles = (J.width + 127) / 128;
    J.tile0 = tiles;
    tiles += J.f_tiles;
  }
  dp.n_tiles = tiles;
  Ranges rw, rb;
  rw.n = n_ranges;
  rb.n = 0;
  for (int l = 0; l < n_ranges; ++l, row += 2) {
    rw.off[l] = row[0];
    rw.size[l] = row[1];
  }

  cudaStream_t st = (cudaStream_t)stream;
  if ((e = cudaFuncSetAttribute(bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)BWD_SMEM)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)DW_SMEM)) != cudaSuccess)
    return (int)e;
  const unsigned grid = (unsigned)(bp.n_tiles < n_sms ? bp.n_tiles : n_sms);
  bwd_data_kernel<<<grid, BW_THREADS, BWD_SMEM, st>>>(
      bp, g, reinterpret_cast<const __nv_bfloat16*>(stash), reinterpret_cast<__nv_bfloat16*>(dpre),
      dbpart);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dw_kernel<<<(unsigned)(tiles * n_chunks), BW_THREADS, DW_SMEM, st>>>(dp, dwpart);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows_kernel<<<(unsigned)((total_w + 31) / 32), THREADS, 0, st>>>(dwpart, n_chunks, total_w,
                                                                       dw, rw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows_kernel<<<(unsigned)((total_b + 31) / 32), THREADS, 0, st>>>(dbpart, bp.n_tiles,
                                                                       total_b, db, rb);
  return (int)cudaGetLastError();
}

}  // namespace
