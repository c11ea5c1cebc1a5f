// Fused positional encoding + DM-NeRF MLP forward for one point query, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel _fwd_kernel_pet
// (dmnerf_tpu/kernels/fused_mlp.py:507), with _pe_transposed and
// _forward_core(transposed=True). What it computes is set out in
// dmnerf_tpu_torch/kernels/fused_mlp.py, whose fused_query_ref is its plain
// version and whose pack_params builds the layer table and weights it reads.
//
// Bound. Per fine point of the flagship model (D=8, W=256, ins_num 32) the layers
// execute 564,864 multiply-accumulates, 1.13 MFLOP, against 4 + 27*2 bytes in and
// 37*4 bytes out: about 5,500 FLOP per byte, far above the card's 295 bf16
// FLOP/byte. The kernel is bound by its executed FLOPs over the 989 TFLOP/s bf16
// tensor-core peak.
//
// Design. What it does about that bound: every product runs on the tensor cores
// (bf16 mma.sync m16n8k16, fp32 accumulators), and nothing but the points, the
// per-ray viewdir embedding and the output touches device memory: the embedding
// and every activation stay in shared memory.
//  * A CTA takes BM = 128 points. Its 8 warps tile each layer's [128, N] output as
//    2 x 4 warp tiles of 64 x 64, accumulators in registers.
//  * One shared-memory row per point holds [ed | h | e] in bf16: the per-ray viewdir
//    embedding, the hidden activation and the point embedding. Each layer reads a
//    contiguous run of that row (e; h; [h | e] at a skip; [ed | h] for the head) and
//    writes its ReLU output back over h after a barrier.
//  * The weights (about 1.1 MB in bf16) do not fit in shared memory. Each layer
//    streams them from L2 in 64-row K slices with cp.async, double-buffered.
//  * The point embedding is computed per element in true fp32: x * 2^f is exact
//    and sincosf is the accurate one (no fast math), because the phases reach
//    2^9 * |x| (thousands of radians) and a rounded phase is an O(1) error.
//  * The viewdir embedding comes per ray ([N, EDP]); point p reads row p / S.
//  * Sigma is a layer of its own ([W, 16], column 0) kept in fp32 in shared
//    memory; the output layer writes it into column 3.
//  * Rows past the ragged tail compute on zeros and are never stored.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // points per CTA
constexpr int THREADS = 256;             // 8 warps: 2 along M x 4 along N
constexpr int KB = 64;                   // weight rows per pipeline stage
constexpr int N_MAX = 256;               // widest layer output
constexpr int ACT_COLS = 352;            // widest [ed | h | e] row
constexpr int LDA = ACT_COLS + 8;        // padded row pitch (bf16): conflict-free ldmatrix
constexpr int LDB = N_MAX + 8;           // padded stage row pitch (bf16)
constexpr int MAX_LAYERS = 20;
constexpr size_t SMEM_BYTES =
    (size_t)BM * LDA * 2 + (size_t)2 * KB * LDB * 2 + (size_t)BM * 4;

enum Epilogue { EPI_RELU = 0, EPI_SIGMA = 1, EPI_OUT = 2 };

struct Layer {
  int a_col, K, N, w_off, b_off, epi;
};

struct Net {
  int n_layers;
  int multires;   // point-embedding octaves
  int h_col;      // first column of h (= width of the viewdir embedding)
  int e_col;      // first column of the point embedding
  int e_width;    // padded point-embedding width
  int c4;         // output columns, 4 + C
  Layer layers[MAX_LAYERS];
};

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

__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_fwd_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ edr,
                     const __nv_bfloat16* __restrict__ weights, const float* __restrict__ biases,
                     float* __restrict__ out, long long P, int S, const Net net) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage = act + BM * LDA;
  float* sigma = reinterpret_cast<float*>(stage + 2 * KB * LDB);

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * BM;

  // ---- prologue: [ed | h | e] rows ----
  const int ed_chunks = net.h_col / 8;
  for (int c = tid; c < BM * ed_chunks; c += THREADS) {
    const int r = c / ed_chunks, q = c - r * ed_chunks;
    const long long p = p0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < P) v = *reinterpret_cast<const uint4*>(edr + (p / S) * net.h_col + q * 8);
    *reinterpret_cast<uint4*>(act + r * LDA + q * 8) = v;
  }
  const int nf = 3 * net.multires;
  __nv_bfloat16* e = act + net.e_col;
  for (int c = tid; c < BM * nf; c += THREADS) {
    const int r = c / nf, j = c - r * nf;
    const int f = j / 3, ch = j - 3 * f;
    const long long p = p0 + r;
    const float x = p < P ? pts[p * 3 + ch] : 0.f;
    float s, co;
    sincosf(x * (float)(1u << f), &s, &co);  // exact phase, accurate sincosf
    e[r * LDA + 3 + j] = __float2bfloat16(s);
    e[r * LDA + 3 + nf + j] = __float2bfloat16(co);
  }
  const int tail = net.e_width - 3 - 2 * nf;  // identity columns + zero padding
  for (int c = tid; c < BM * (3 + tail); c += THREADS) {
    const int r = c / (3 + tail), j = c - r * (3 + tail);
    const long long p = p0 + r;
    float v = 0.f;
    if (j < 3 && p < P) v = pts[p * 3 + j];
    e[r * LDA + (j < 3 ? j : 2 * nf + j)] = __float2bfloat16(v);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile rows wm*64, cols wn*64
  const int g = lane >> 2, t4 = lane & 3;    // accumulator fragment coordinates

  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layers[l];
    const __nv_bfloat16* w = weights + L.w_off;
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

    // ---- main loop: acc = act[:, a_col : a_col + K] @ w ----
    const int n_slices = (L.K + KB - 1) / KB;
    load_stage(stage, w, 0, L.K, L.N);
    cp_async_commit();
    for (int s = 0; s < n_slices; ++s) {
      if (s + 1 < n_slices) {
        load_stage(stage + ((s + 1) & 1) * KB * LDB, w, (s + 1) * KB, L.K, L.N);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* bs = stage + (s & 1) * KB * LDB;
      const int kb = min(KB, L.K - s * KB);
      for (int kk = 0; kk < kb; kk += 16) {
        uint32_t bfrag[8][2];
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int n0 = wn * 64 + jp * 16;
          if (n0 < L.N) {
            const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int n = n0 + (lane >> 4) * 8;
            ldmatrix_x4_trans(bfrag[2 * jp][0], bfrag[2 * jp][1], bfrag[2 * jp + 1][0],
                              bfrag[2 * jp + 1][1], bs + k * LDB + n);
          }
        }
        if (wn * 64 >= L.N) continue;  // this warp's columns are all padding
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[4];
          const int row = wm * 64 + i * 16 + (lane & 15);
          ldmatrix_x4(a, act + row * LDA + L.a_col + s * KB + kk + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (wn * 64 + j * 8 < L.N) mma_bf16(acc[i][j], a, bfrag[j]);
        }
      }
      __syncthreads();  // every warp is done with this stage (and, last, with act)
    }

    // ---- epilogue ----
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
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was accepted).
// `table` holds n_layers rows of (a_col, K, N, w_off, b_off, epilogue).
extern "C" int dmnerf_fused_mlp_fwd(const float* pts, const void* edr, const void* weights,
                                    const float* biases, float* out, long long P, int S,
                                    const int* table, int n_layers, int multires, int h_col,
                                    int e_col, int e_width, int c4, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || P <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Net net;
  net.n_layers = n_layers;
  net.multires = multires;
  net.h_col = h_col;
  net.e_col = e_col;
  net.e_width = e_width;
  net.c4 = c4;
  for (int l = 0; l < n_layers; ++l) {
    const int* t = table + 6 * l;
    net.layers[l] = Layer{t[0], t[1], t[2], t[3], t[4], t[5]};
  }
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (P + BM - 1) / BM;
  fused_mlp_fwd_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      reinterpret_cast<const float*>(pts), reinterpret_cast<const __nv_bfloat16*>(edr),
      reinterpret_cast<const __nv_bfloat16*>(weights), biases, out, P, S, net);
  return (int)cudaGetLastError();
}
