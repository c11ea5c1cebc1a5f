// K7: the standalone positional encoding of the points, sm_90a. Replaces the JAX
// package's Pallas TPU kernel make_pe_pallas.kernel (dmnerf_tpu/kernels/fused_mlp.py:689,
// pallas_call at :699), pe_mode 'outside': x [P, 3] fp32 -> e [P, width] bf16 with the
// lanes [x | sin(2^f x) freq-major | cos(2^f x) freq-major | 0 pad], the embedding that
// K5 (fused_mlp_fwd_pe.cu) and K6 (fused_mlp_bwd_pe.cu) read.
//
// Bound. 12 bytes in and 2 * width bytes out a point (140 at the flagship's width 64)
// against 6 * multires transcendentals: bytes over the card's 3.35 TB/s.
//
// Design. A CTA of 256 threads takes 128 points. It builds their rows in shared
// memory with embed_rows (fused_mlp_common.cuh), the same function that K1 and K3
// run in their prologue, so the output is bit for bit the bf16 embedding those
// kernels build and one function defines the phases: x * 2^f exact, accurate
// sincosf (no fast math; the phases reach 2^9 |x|, thousands of radians at far = 9.5).
// Then store_rows writes each row to device memory as 16-byte chunks, neighbouring
// threads on neighbouring addresses. Rows past P are not stored.

#include "fused_mlp_common.cuh"

namespace {

using namespace dmnerf;

constexpr int MAX_WIDTH = 256;

__global__ void __launch_bounds__(THREADS)
fused_pe_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ e, long long P,
                int multires, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][width + 8]
  const int ld = width + 8;
  const long long p0 = (long long)blockIdx.x * BM;
  embed_rows(rows, x, p0, P, multires, width, ld);
  __syncthreads();
  store_rows(e, rows, ld, 0, width, p0, P);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was accepted).
// `width` is a multiple of 8, at least 3 * (1 + 2 * multires) and at most 256.
extern "C" int dmnerf_fused_pe(const float* x, void* e, long long P, int multires, int width,
                               void* stream) {
  if (P <= 0 || multires < 1 || width % 8 || width < 3 * (1 + 2 * multires) ||
      width > MAX_WIDTH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BM * (width + 8) * sizeof(__nv_bfloat16);
  const long long grid = (P + BM - 1) / BM;
  fused_pe_kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, reinterpret_cast<__nv_bfloat16*>(e), P, multires, width);
  return (int)cudaGetLastError();
}
