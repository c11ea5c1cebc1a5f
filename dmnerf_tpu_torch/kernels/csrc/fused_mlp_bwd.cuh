// Parameter backward of the fused positional encoding + DM-NeRF MLP point query,
// sm_90a: the kernels and the launch sequence behind three entry points.
//
//  * fused_mlp_bwd.cu (K2) replaces the JAX package's Pallas TPU kernel
//    _bwd_kernel_pet (dmnerf_tpu/kernels/fused_mlp.py:520), pe_mode 'kernel_t': the
//    viewdir embedding comes per ray and the head's dW job reads it from that table.
//  * fused_mlp_bwd_kpe.cu (K4) replaces _bwd_kernel (:481), pe_mode 'kernel': the
//    stash forward embeds each point's own direction and stashes that embedding
//    beside the point embedding, and the head's dW job reads it from the stash.
//  * fused_mlp_bwd_pe.cu (K6) replaces _bwd_kernel_pe (:494), pe_mode 'outside': the
//    point embedding and the per-point viewdir embedding come in as bf16 rows (saved
//    by the forward), the stash forward copies them into shared memory, and the dW
//    jobs read both from those input buffers (segment source 2 for e, 1 for ed), so
//    neither is stashed again.
// All three carry _backward_core (:536) and _accumulate_grads (:653). What they
// compute is set out in dmnerf_tpu_torch/kernels/fused_mlp.py, whose
// fused_query_bwd_ref / fused_query_kpe_bwd_ref / fused_query_pe_bwd_ref are their
// plain versions and whose _bwd_plan builds the tables they read. Numerics follow the
// JAX package: bf16 operands for every product (activations, cotangents cast once,
// weights), fp32 accumulation, and bias gradients summed from the fp32 cotangents.
// Nothing flows into the points, the directions or the embeddings (the JAX package
// returns zeros for them).
//
// Bound. Per flagship point (D=8, W=256, ins_num 32) the backward's own products
// are dW, the forward's 564,864 multiply-accumulates, and dX into the trunk,
// 7 * 256^2 + 256 * 129 + 128 * 36 = 496,384: 2.12 MFLOP against a few hundred
// bytes of inputs, so the bound is operations over the 989 TFLOP/s bf16 peak. This
// design also executes the forward once more (the rematerialisation with stash,
// 1.13 MFLOP a point), which the bound does not count.
//
// Design: five launches, all in a fixed order with no atomics, so the same inputs
// give bit-identical gradients.
//  1. fwd_stash_kernel: the forward kernel's trunk and head (fused_mlp_fwd.cuh's code:
//     128 points a CTA, [ed | h | e] rows in shared memory, weights streamed from
//     L2 with cp.async, mma.sync bf16) storing the point embedding (not K6), the
//     per-point viewdir embedding (K4 only: 64 B a flagship point) and every
//     post-ReLU activation, bf16, to a stash in device memory (about 4.7 KB a
//     flagship point: 2.8 GB for 589,824 fine points, on an 80 GB card). The TPU
//     rematerialises per tile instead, because its 16 GB could not hold the stash.
//  2. bwd_data_kernel: 128 points a CTA walk the table in reverse. The cotangent
//     rows of the current layer live in shared memory; each dX product is the same
//     streamed mma.sync loop against host-transposed bf16 weight blocks. Each
//     layer's cotangent d_pre (masked by the stashed ReLU output) is written bf16 to
//     device memory, and its fp32 column sums to a per-CTA bias partial. The head's
//     ins columns are stored for dW but never enter the dX product (the instance
//     head's detach); nothing flows into ed.
//  3. dw_kernel: dW_l = A_l^T d_pre_l, split over the point axis. A CTA owns a
//     128 x 128 tile of one layer's dW and a fixed range of points, streams 32-point
//     slices of A_l (stash segments, the viewdir table, or K6's e) and d_pre_l
//     through shared memory, and writes an fp32 partial tile.
//  4. reduce_kernel on the dW partials and 5. on the bias partials: fixed-order
//     sums over the point ranges and over the CTAs.
// wgmma, TMA, and fusing launches 1-3 are left for later work.
#pragma once

#include "fused_mlp_common.cuh"

namespace {

using namespace dmnerf;

constexpr int LDG = N_MAX + 8;           // padded cotangent row pitch (bf16)
constexpr int SIG_N = 16;                // width of the sigma layer
constexpr size_t FWD_SMEM = (size_t)BM * LDA * 2 + (size_t)2 * KB * LDB * 2;
constexpr size_t BWD_SMEM =
    (size_t)BM * LDG * 2 + (size_t)2 * KB * LDB * 2 + (size_t)2 * N_MAX * 4 + (size_t)BM * 2;

constexpr int TF = 128;                  // dW tile: features (rows of dW)
constexpr int TN = 128;                  // dW tile: output columns
constexpr int KP = 32;                   // points per dW pipeline stage
constexpr int LDF = TF + 8;
constexpr int LDN = TN + 8;
constexpr size_t DW_SMEM = (size_t)2 * KP * (LDF + LDN) * 2;

struct FwdLayer {
  int a_col, K, N, w_off, b_off;
  long long stash_off;
};

struct FwdNet {
  int n_layers, multires, multires_views, h_col, e_col, e_width;
  long long e_stash_off, ed_stash_off;   // ed_stash_off: per-point directions only
  FwdLayer layers[MAX_LAYERS];
};

struct Step {
  int K, N, b_off, sigma_after;
  long long wt_off, mask_off, dpre_off;
};

struct BwdNet {
  int n_steps, c4, no, hr, total_b, b_out, b_sigma;
  long long dpre_out, dpre_sigma;
  Step steps[MAX_LAYERS];
};

struct Seg {
  int src;        // 0: stash, 1: the viewdir table (K2 per ray, K6 per point), 2: e (K6)
  int width, ld, div;
  long long off;
};

struct DwLayer {
  int K, N, w_off, tiles_n, tile_start;
  long long dpre_off;
  Seg seg[2];
};

struct DwNet {
  int n_layers, n_tiles;
  long long chunk;
  DwLayer layers[MAX_LAYERS];
};

// ---- launch 1: the forward's trunk and head, storing e (K2, K4), the per-point ed
// (K4) and every ReLU output ----
template <Rows ROWS>
__global__ void __launch_bounds__(THREADS, 1)
fwd_stash_kernel(const void* __restrict__ pt_src, const void* __restrict__ ed_src,
                 const __nv_bfloat16* __restrict__ weights, const float* __restrict__ biases,
                 __nv_bfloat16* __restrict__ stash, long long P, int S, const FwdNet net) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage = act + BM * LDA;

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * BM;
  build_rows<ROWS>(act, pt_src, ed_src, p0, P, S, net.multires, net.multires_views, net.h_col,
                   net.e_col, net.e_width);
  __syncthreads();
  if (ROWS != ROWS_EMBEDDED)
    store_rows(stash + net.e_stash_off, act, LDA, net.e_col, net.e_width, p0, P);
  if (ROWS == ROWS_POINT_DIRS) store_rows(stash + net.ed_stash_off, act, LDA, 0, net.h_col, p0, P);

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  for (int l = 0; l < net.n_layers; ++l) {
    const FwdLayer L = net.layers[l];
    float acc[4][8][4];
    // the product's first barrier also orders the previous layer's store_rows reads
    // before this layer's epilogue writes
    tile_product(acc, act, LDA, L.a_col, weights + L.w_off, L.K, L.N, stage);
    const float* bias = biases + L.b_off;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn * 64 + j * 8 + t4 * 2;
        if (col >= L.N) continue;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm * 64 + i * 16 + g + half * 8;
          *reinterpret_cast<__nv_bfloat162*>(act + row * LDA + net.h_col + col) =
              __floats2bfloat162_rn(fmaxf(acc[i][j][2 * half] + b0, 0.f),
                                    fmaxf(acc[i][j][2 * half + 1] + b1, 0.f));
        }
      }
    }
    __syncthreads();
    store_rows(stash + L.stash_off, act, LDA, net.h_col, L.N, p0, P);
  }
}

// ---- launch 2: cotangents of every layer, walking the table in reverse ----
__global__ void __launch_bounds__(THREADS, 1)
bwd_data_kernel(const float* __restrict__ gout, const __nv_bfloat16* __restrict__ wt,
                const __nv_bfloat16* __restrict__ stash, __nv_bfloat16* __restrict__ dpre,
                float* __restrict__ dbpart, long long P, const BwdNet net) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* G = reinterpret_cast<__nv_bfloat16*>(smem);           // [BM][LDG]
  __nv_bfloat16* stage = G + BM * LDG;                                  // [2][KB][LDB]
  float* dbs = reinterpret_cast<float*>(stage + 2 * KB * LDB);          // [2][N_MAX]
  __nv_bfloat16* sig = reinterpret_cast<__nv_bfloat16*>(dbs + 2 * N_MAX);  // [BM]

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * BM;
  float* dbrow = dbpart + (long long)blockIdx.x * net.total_b;

  // out layer: d_pre = g with sigma's column 3 and the padding zeroed; sigma layer:
  // d_pre = [g_sigma | 0]. Both cast to bf16 once; bias sums from the fp32 g.
  for (int c = tid; c < BM * net.no; c += THREADS) {
    const int r = c / net.no, j = c - r * net.no;
    const long long p = p0 + r;
    const float v = (p < P && j < net.c4 && j != 3) ? gout[p * net.c4 + j] : 0.f;
    G[r * LDG + j] = __float2bfloat16(v);
  }
  for (int r = tid; r < BM; r += THREADS) {
    const long long p = p0 + r;
    sig[r] = __float2bfloat16(p < P ? gout[p * net.c4 + 3] : 0.f);
  }
  if (tid < net.no) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) {
      const long long p = p0 + r;
      if (p < P && tid < net.c4) s += gout[p * net.c4 + tid];
    }
    if (tid == 3) {
      dbrow[net.b_sigma] = s;
      dbrow[net.b_out + 3] = 0.f;
    } else {
      dbrow[net.b_out + tid] = s;
    }
  }
  if (tid >= 1 && tid < SIG_N) dbrow[net.b_sigma + tid] = 0.f;
  __syncthreads();
  store_rows(dpre + net.dpre_out, G, LDG, 0, net.no, p0, P);
  for (int c = tid; c < BM * SIG_N; c += THREADS) {
    const int r = c / SIG_N, j = c - r * SIG_N;
    const long long p = p0 + r;
    if (p < P) dpre[net.dpre_sigma + p * SIG_N + j] = j == 0 ? sig[r] : __float2bfloat16(0.f);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  for (int s = 0; s < net.n_steps; ++s) {
    const Step st = net.steps[s];
    float acc[4][8][4];
    // dX = G[:, 0:K] @ wt_s; its first barrier orders the G writes above and the
    // previous step's reads of dbs and G before this step's epilogue
    tile_product(acc, G, LDG, 0, wt + st.wt_off, st.K, st.N, stage);
    const __nv_bfloat16* mask = stash + st.mask_off;
    float cs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn * 64 + j * 8 + t4 * 2;
        if (col >= st.N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm * 64 + i * 16 + g + half * 8;
          const long long p = p0 + row;
          float v0 = 0.f, v1 = 0.f;
          if (p < P) {
            const __nv_bfloat162 h =
                *reinterpret_cast<const __nv_bfloat162*>(mask + p * st.N + col);
            v0 = __bfloat162float(h.x) > 0.f ? acc[i][j][2 * half] : 0.f;
            v1 = __bfloat162float(h.y) > 0.f ? acc[i][j][2 * half + 1] : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(G + row * LDG + col) = __floats2bfloat162_rn(v0, v1);
          cs[j][0] += v0;
          cs[j][1] += v1;
        }
      }
    }
    // fp32 column sums over the warp's 64 rows (lanes of equal t4), then over the
    // two warps along M, in a fixed order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        cs[j][0] += __shfl_xor_sync(0xffffffffu, cs[j][0], m);
        cs[j][1] += __shfl_xor_sync(0xffffffffu, cs[j][1], m);
      }
      const int col = wn * 64 + j * 8 + t4 * 2;
      if (g == 0 && col < st.N) {
        dbs[wm * N_MAX + col] = cs[j][0];
        dbs[wm * N_MAX + col + 1] = cs[j][1];
      }
    }
    __syncthreads();
    store_rows(dpre + st.dpre_off, G, LDG, 0, st.N, p0, P);
    if (tid < st.N) dbrow[st.b_off + tid] = dbs[tid] + dbs[N_MAX + tid];
    if (st.sigma_after) {
      // the next product reads [d_rh | d_sigma]: the ins columns it must not see are
      // overwritten by the sigma block, once store_rows has read them
      __syncthreads();
      for (int c = tid; c < BM * SIG_N; c += THREADS) {
        const int r = c / SIG_N, j = c - r * SIG_N;
        G[r * LDG + net.hr + j] = j == 0 ? sig[r] : __float2bfloat16(0.f);
      }
    }
  }
}

// ---- launch 3: dW partials, split over the point axis ----
__global__ void __launch_bounds__(THREADS, 2)
dw_kernel(const __nv_bfloat16* __restrict__ stash, const __nv_bfloat16* __restrict__ edr,
          const __nv_bfloat16* __restrict__ e_in, const __nv_bfloat16* __restrict__ dpre,
          float* __restrict__ dwpart, long long P,
          long long total_w, const DwNet net) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][KP][LDF]
  __nv_bfloat16* Ds = As + 2 * KP * LDF;                         // [2][KP][LDN]

  int li = 0;
  while (li + 1 < net.n_layers && (int)blockIdx.x >= net.layers[li + 1].tile_start) ++li;
  const DwLayer L = net.layers[li];
  const int local = blockIdx.x - L.tile_start;
  const int f0 = (local / L.tiles_n) * TF, n0 = (local % L.tiles_n) * TN;
  const long long pbeg = (long long)blockIdx.y * net.chunk;
  const long long pend = min(P, pbeg + net.chunk);
  const int n_st = (int)((pend - pbeg + KP - 1) / KP);
  const __nv_bfloat16* dp = dpre + L.dpre_off;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;       // warp tile: features wm*64, cols wn*32
  const int g = lane >> 2, t4 = lane & 3;
  const bool live = f0 + wm * 64 < L.K && n0 + wn * 32 < L.N;

  auto load = [&](int st, int buf) {
    const long long pb = pbeg + (long long)st * KP;
    for (int c = tid; c < KP * (TF / 8); c += THREADS) {
      const int r = c / (TF / 8), q = c - r * (TF / 8);
      const long long p = pb + r;
      const int f = f0 + q * 8;
      __nv_bfloat16* dst = As + (buf * KP + r) * LDF + q * 8;
      if (p < pend && f < L.K) {
        const Seg sg = f < L.seg[0].width ? L.seg[0] : L.seg[1];
        const int ff = f < L.seg[0].width ? f : f - L.seg[0].width;
        const __nv_bfloat16* base = sg.src == 0 ? stash : sg.src == 1 ? edr : e_in;
        cp_async16(dst, base + sg.off + (p / sg.div) * sg.ld + ff);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int c = tid; c < KP * (TN / 8); c += THREADS) {
      const int r = c / (TN / 8), q = c - r * (TN / 8);
      const long long p = pb + r;
      const int n = n0 + q * 8;
      __nv_bfloat16* dst = Ds + (buf * KP + r) * LDN + q * 8;
      if (p < pend && n < L.N) {
        cp_async16(dst, dp + p * L.N + n);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  if (n_st > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) {
      load(st + 1, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const __nv_bfloat16* as = As + (st & 1) * KP * LDF;
      const __nv_bfloat16* ds = Ds + (st & 1) * KP * LDN;
#pragma unroll
      for (int kk = 0; kk < KP; kk += 16) {
        // A = A_l^T: stored [point][feature], loaded transposed into m16 x k16 fragments
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = lane >> 3;
          const int k = kk + (lane & 7) + (q >> 1) * 8;
          const int m = wm * 64 + i * 16 + (q & 1) * 8;
          ldmatrix_x4_trans(a[i][0], a[i][1], a[i][2], a[i][3], as + k * LDF + m);
        }
        uint32_t b[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = wn * 32 + jp * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(b[2 * jp][0], b[2 * jp][1], b[2 * jp + 1][0], b[2 * jp + 1][1],
                            ds + k * LDN + n);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  float* out = dwpart + (long long)blockIdx.y * total_w + L.w_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + t4 * 2;
      if (n >= L.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = f0 + wm * 64 + i * 16 + g + half * 8;
        if (f < L.K)
          *reinterpret_cast<float2*>(out + (long long)f * L.N + n) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

// ---- launches 4 and 5: out[c] = sum_r part[r][c], r in a fixed order ----
// A CTA takes 32 columns; its 8 warps sum strided rows, then warp 0 adds the 8
// partial sums in order. With a table (dW), columns outside every layer's [K, N]
// block are alignment padding and are written as 0.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, long long R, long long C, float* __restrict__ out,
              const DwNet net, int use_table) {
  __shared__ float sums[THREADS / 32][32];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + cx;
  bool inside = c < C;
  if (inside && use_table) {
    inside = false;
    for (int l = 0; l < net.n_layers; ++l) {
      const DwLayer& L = net.layers[l];
      if (c >= L.w_off && c < (long long)L.w_off + (long long)L.K * L.N) inside = true;
    }
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

// Launch the five kernels on `stream`; returns the first cudaError (0 when every
// launch was accepted). `pt_src` and `ed_src` are build_rows' (Rows). `table` is the
// int64 table of
// fused_mlp.py's _bwd_plan:
//   header  P, S, multires, h_col, e_col, e_width, c4, no, hr, total_b, total_w,
//           b_out, b_sigma, dpre_out, dpre_sigma, n_chunks, chunk, n_fwd, n_steps, n_dw,
//           multires_views, ed_stash_off
//   n_fwd   rows a_col, K, N, w_off, b_off, stash_off           (trunk layers, head)
//   n_steps rows K, N, wt_off, mask_off, dpre_off, b_off, sigma_after
//   n_dw    rows K, N, w_off, dpre_off, then two segments of src, off, width, ld, div
template <Rows ROWS>
int run_fused_mlp_bwd(const void* pt_src, const void* ed_src, const void* weights,
                      const float* biases, const void* wt, const float* g, void* stash,
                      void* dpre, float* dbpart, float* dwpart, float* dw, float* db,
                      const long long* table, void* stream) {
  const long long* h = table;
  const long long P = h[0];
  const int S = (int)h[1];
  const int n_fwd = (int)h[17], n_steps = (int)h[18], n_dw = (int)h[19];
  if (P <= 0 || S <= 0 || n_fwd < 1 || n_fwd > MAX_LAYERS || n_steps < 1 ||
      n_steps > MAX_LAYERS || n_dw < 1 || n_dw > MAX_LAYERS ||
      (ROWS == ROWS_POINT_DIRS && h[21] < 0) || (ROWS == ROWS_EMBEDDED && S != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = h[15];
  const long long total_b = h[9], total_w = h[10];
  const long long* row = table + 22;

  FwdNet fwd;
  fwd.n_layers = n_fwd;
  fwd.multires = (int)h[2];
  fwd.multires_views = (int)h[20];
  fwd.h_col = (int)h[3];
  fwd.e_col = (int)h[4];
  fwd.e_width = (int)h[5];
  fwd.e_stash_off = 0;
  fwd.ed_stash_off = h[21];
  for (int l = 0; l < n_fwd; ++l, row += 6)
    fwd.layers[l] = FwdLayer{(int)row[0], (int)row[1], (int)row[2], (int)row[3], (int)row[4], row[5]};

  BwdNet bwd;
  bwd.n_steps = n_steps;
  bwd.c4 = (int)h[6];
  bwd.no = (int)h[7];
  bwd.hr = (int)h[8];
  bwd.total_b = (int)total_b;
  bwd.b_out = (int)h[11];
  bwd.b_sigma = (int)h[12];
  bwd.dpre_out = h[13];
  bwd.dpre_sigma = h[14];
  for (int s = 0; s < n_steps; ++s, row += 7)
    bwd.steps[s] = Step{(int)row[0], (int)row[1], (int)row[5], (int)row[6], row[2], row[3], row[4]};

  DwNet dwn;
  dwn.n_layers = n_dw;
  dwn.chunk = h[16];
  int tiles = 0;
  for (int l = 0; l < n_dw; ++l, row += 14) {
    DwLayer& L = dwn.layers[l];
    L.K = (int)row[0];
    L.N = (int)row[1];
    L.w_off = (int)row[2];
    L.dpre_off = row[3];
    for (int k = 0; k < 2; ++k) {
      const long long* sg = row + 4 + 5 * k;
      L.seg[k] = Seg{(int)sg[0], (int)sg[2], (int)sg[3], (int)sg[4], sg[1]};
    }
    L.tiles_n = (L.N + TN - 1) / TN;
    L.tile_start = tiles;
    tiles += ((L.K + TF - 1) / TF) * L.tiles_n;
  }
  dwn.n_tiles = tiles;

  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  err = cudaFuncSetAttribute(fwd_stash_kernel<ROWS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DW_SMEM);
  if (err != cudaSuccess) return (int)err;

  const unsigned grid = (unsigned)((P + BM - 1) / BM);
  // the dW kernel reads the viewdir table only through the head segment of K2 and K6
  // (src 1), and the input e only through K6's segments (src 2)
  const __nv_bfloat16* edr_b =
      ROWS == ROWS_POINT_DIRS ? nullptr : reinterpret_cast<const __nv_bfloat16*>(ed_src);
  const __nv_bfloat16* e_b =
      ROWS == ROWS_EMBEDDED ? reinterpret_cast<const __nv_bfloat16*>(pt_src) : nullptr;
  __nv_bfloat16* stash_b = reinterpret_cast<__nv_bfloat16*>(stash);
  __nv_bfloat16* dpre_b = reinterpret_cast<__nv_bfloat16*>(dpre);
  fwd_stash_kernel<ROWS><<<grid, THREADS, FWD_SMEM, st>>>(
      pt_src, ed_src, reinterpret_cast<const __nv_bfloat16*>(weights), biases, stash_b, P, S, fwd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_data_kernel<<<grid, THREADS, BWD_SMEM, st>>>(
      g, reinterpret_cast<const __nv_bfloat16*>(wt), stash_b, dpre_b, dbpart, P, bwd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)n_chunks), THREADS, DW_SMEM, st>>>(
      stash_b, edr_b, e_b, dpre_b, dwpart, P, total_w, dwn);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((total_w + 31) / 32), THREADS, 0, st>>>(dwpart, n_chunks, total_w,
                                                                    dw, dwn, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((total_b + 31) / 32), THREADS, 0, st>>>(dbpart, (long long)grid,
                                                                    total_b, db, dwn, 0);
  return (int)cudaGetLastError();
}

}  // namespace
