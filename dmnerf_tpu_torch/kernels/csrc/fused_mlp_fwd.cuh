// Fused positional encoding + DM-NeRF MLP forward for one point query, sm_90a: the
// kernel template behind three entry points.
//
//  * fused_mlp_fwd.cu (K1) replaces the JAX package's Pallas TPU kernel
//    _fwd_kernel_pet (dmnerf_tpu/kernels/fused_mlp.py:507), pe_mode 'kernel_t': the
//    viewdir embedding comes per ray ([N, EDP] bf16) and point p reads row p / S.
//  * fused_mlp_fwd_kpe.cu (K3) replaces _fwd_kernel (:462, with _embed_pair :354),
//    pe_mode 'kernel': the kernel takes each point's own direction ([P, 3] fp32) and
//    embeds it, as it embeds the point.
//  * fused_mlp_fwd_pe.cu (K5) replaces _fwd_kernel_pe (:471), pe_mode 'outside': the
//    point embedding (built by K7, fused_pe.cu) and the per-point viewdir embedding
//    come in as bf16 rows, and the kernel is the matrix-product chain alone.
// The three differ only in how the ed and e columns of a row are filled (build_rows,
// Rows). What they compute is set out in dmnerf_tpu_torch/kernels/fused_mlp.py, whose
// fused_query_ref / fused_query_kpe_ref / fused_query_pe_ref are their plain versions
// and whose pack_params builds the layer table and weights they read.
//
// Bound. Per fine point of the flagship model (D=8, W=256, ins_num 32) the layers
// execute 564,864 multiply-accumulates, 1.13 MFLOP, against 4 * (3 + 3) bytes in (K3;
// K1 reads 12 + 64 / S, K5 2 * (64 + 32)) and 37 * 4 bytes out: at least 3,300 FLOP
// per byte, far above the card's 295 bf16 FLOP/byte. The kernel is bound by its executed FLOPs over the
// 989 TFLOP/s bf16 tensor-core peak.
//
// Design. What it does about that bound: every product runs on the tensor cores
// (bf16 mma.sync m16n8k16, fp32 accumulators), and nothing but the points, the
// directions (or the per-ray viewdir embedding) and the output touches device
// memory: the embeddings (K5: once they are read) and every activation stay in
// shared memory.
//  * A CTA takes BM = 128 points. Its 8 warps tile each layer's [128, N] output as
//    2 x 4 warp tiles of 64 x 64, accumulators in registers.
//  * One shared-memory row per point holds [ed | h | e] in bf16: the viewdir
//    embedding, the hidden activation and the point embedding. Each layer reads a
//    contiguous run of that row (e; h; [h | e] at a skip; [ed | h] for the head) and
//    writes its ReLU output back over h after a barrier.
//  * The weights (about 1.1 MB in bf16) do not fit in shared memory. Each layer
//    streams them from L2 in 64-row K slices with cp.async, double-buffered.
//  * Embeddings are computed per element in true fp32 (embed_rows: exact phases,
//    accurate sincosf), then rounded to bf16; K5 copies K7's, which embed_rows made.
//  * Sigma is a layer of its own ([W, 16], column 0) kept in fp32 in shared
//    memory; the output layer writes it into column 3.
//  * Rows past the ragged tail compute on zeros and are never stored.
// The kernel is still built from mma.sync with cp.async-streamed weights; moving it to
// wgmma, TMA-fed weight tiles and warp specialisation is the next redesign.
//
// Training. With STASH the same kernel is the training forward: it also stores what
// the parameter backward (fused_mlp_bwd.cuh) reads, in the layout of fused_mlp.py's
// _bwd_plan: the point embedding and the per-point viewdir embedding as the CTA built
// them (K1, K3; K5's come from its inputs), and every ReLU output (the trunk layers
// and the head) as the bf16 values the next layer reads. These are plain 16-byte row
// stores after the layer's barrier; the products and the output are the same code, so
// raw is bit for bit the render path's. Without STASH the added code compiles away.
#pragma once

#include "fused_mlp_common.cuh"

namespace {

using namespace dmnerf;

constexpr size_t FWD_SMEM_BYTES =
    (size_t)BM * LDA * 2 + (size_t)2 * KB * LDB * 2 + (size_t)BM * 4;

enum Epilogue { EPI_RELU = 0, EPI_SIGMA = 1, EPI_OUT = 2 };

struct Layer {
  int a_col, K, N, w_off, b_off, epi;
};

// Element offsets into the bf16 stash (fused_mlp.py's _bwd_plan), -1 where nothing is
// stored: the point and viewdir embeddings, then one entry per layer of the table.
struct StashNet {
  long long e_off, ed_off;
  long long layer_off[MAX_LAYERS];
};

struct Net {
  int n_layers;
  int multires;        // point-embedding octaves
  int multires_views;  // viewdir-embedding octaves (per-point directions only)
  int h_col;           // first column of h (= width of the viewdir embedding)
  int e_col;           // first column of the point embedding
  int e_width;         // padded point-embedding width
  int c4;              // output columns, 4 + C
  Layer layers[MAX_LAYERS];
};

template <Rows ROWS, bool STASH>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_fwd_kernel(const void* __restrict__ pt_src, const void* __restrict__ ed_src,
                     const __nv_bfloat16* __restrict__ weights, const float* __restrict__ biases,
                     float* __restrict__ out, long long P, int S, const Net net,
                     __nv_bfloat16* __restrict__ stash, const StashNet sn) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage = act + BM * LDA;
  float* sigma = reinterpret_cast<float*>(stage + 2 * KB * LDB);

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * BM;
  build_rows<ROWS>(act, pt_src, ed_src, p0, P, S, net.multires, net.multires_views, net.h_col,
                   net.e_col, net.e_width);
  __syncthreads();
  if constexpr (STASH) {
    // the embeddings' columns are never written again, so no barrier orders these reads
    if (sn.e_off >= 0) store_rows(stash + sn.e_off, act, LDA, net.e_col, net.e_width, p0, P);
    if (sn.ed_off >= 0) store_rows(stash + sn.ed_off, act, LDA, 0, net.h_col, p0, P);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile rows wm*64, cols wn*64
  const int g = lane >> 2, t4 = lane & 3;    // accumulator fragment coordinates

  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layers[l];
    float acc[4][8][4];
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
          const float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
          if (L.epi == EPI_RELU) {
            *reinterpret_cast<__nv_bfloat162*>(act + row * LDA + net.h_col + col) =
                __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          } else if (L.epi == EPI_SIGMA) {
            if (col == 0) sigma[row] = v0;
          } else {
            const long long p = p0 + row;
            if (p < P) {
              float* o = out + p * net.c4;
              if (col < net.c4) o[col] = col == 3 ? sigma[row] : v0;
              if (col + 1 < net.c4) o[col + 1] = col + 1 == 3 ? sigma[row] : v1;
            }
          }
        }
      }
    }
    __syncthreads();
    if constexpr (STASH) {
      // the next layer's product ends in a barrier before its epilogue overwrites h
      if (sn.layer_off[l] >= 0)
        store_rows(stash + sn.layer_off[l], act, LDA, net.h_col, L.N, p0, P);
    }
  }
}

template <Rows ROWS, bool STASH>
int launch_kernel(const void* pt_src, const void* ed_src, const void* weights, const float* biases,
                  float* out, long long P, int S, const Net& net, void* stash, const StashNet& sn,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel<ROWS, STASH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (P + BM - 1) / BM;
  fused_mlp_fwd_kernel<ROWS, STASH>
      <<<(unsigned)grid, THREADS, FWD_SMEM_BYTES, (cudaStream_t)stream>>>(
          pt_src, ed_src, reinterpret_cast<const __nv_bfloat16*>(weights), biases, out, P, S, net,
          reinterpret_cast<__nv_bfloat16*>(stash), sn);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was accepted).
// `table` holds n_layers rows of (a_col, K, N, w_off, b_off, epilogue). With a stash
// (the training forward), `stash_table` is _bwd_plan's (e_off, ed_off, then one
// offset per layer); without one, the render path's kernel runs.
template <Rows ROWS>
int launch_fused_mlp_fwd(const void* pt_src, const void* ed_src, const void* weights,
                         const float* biases, float* out, long long P, int S, const int* table,
                         int n_layers, int multires, int multires_views, int h_col, int e_col,
                         int e_width, int c4, void* stash, const long long* stash_table,
                         void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || P <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Net net;
  net.n_layers = n_layers;
  net.multires = multires;
  net.multires_views = multires_views;
  net.h_col = h_col;
  net.e_col = e_col;
  net.e_width = e_width;
  net.c4 = c4;
  for (int l = 0; l < n_layers; ++l) {
    const int* t = table + 6 * l;
    net.layers[l] = Layer{t[0], t[1], t[2], t[3], t[4], t[5]};
  }
  StashNet sn;
  sn.e_off = sn.ed_off = -1;
  for (int l = 0; l < MAX_LAYERS; ++l) sn.layer_off[l] = -1;
  if (stash == nullptr)
    return launch_kernel<ROWS, false>(pt_src, ed_src, weights, biases, out, P, S, net, stash, sn,
                                      stream);
  sn.e_off = stash_table[0];
  sn.ed_off = stash_table[1];
  for (int l = 0; l < n_layers; ++l) sn.layer_off[l] = stash_table[2 + l];
  return launch_kernel<ROWS, true>(pt_src, ed_src, weights, biases, out, P, S, net, stash, sn,
                                   stream);
}

}  // namespace
