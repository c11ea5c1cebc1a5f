// K8c, K8f: the fused render passes, sm_90a: points, positional encoding, the DM-NeRF MLP
// and volume compositing in one launch, so raw never reaches device memory. Replaces the
// Pallas TPU kernel of scripts/dev/fused_render_probe.py (_render_kernel :62, pallas_call
// :142), which the JAX package measured as a probe and never wired into its renderer.
//  * K8c (dmnerf_fused_render_weights): the coarse pass, the layer table cut after sigma
//    (the sigma stub's trunk and density column), then the weights [N, S] that
//    sample_pdf reads.
//  * K8f (dmnerf_fused_render_maps): the fine pass, the whole table, then [N, 4 + C] =
//    [sum w sigmoid(rgb) | sum w z | sigmoid(sum w logits)], the air channel kept.
// What they compute is dmnerf_tpu_torch/kernels/fused_render.py's fused_render_ref; its
// host plan (_render_plan) gives the walk.
//
// Bound. The products are K1's (fused_mlp_fwd.cuh): at the flagship render chunk 2048 x
// 192 fine points through the full model, 0.449 ms of executed matrix FLOPs over the
// card's 989 TFLOP/s bf16 peak; 2048 x 64 coarse points through the sigma stub's trunk
// and sigma, 0.130 ms. Compositing adds ≈ 100 FLOP a point (≈ 40 MFLOP a fine chunk,
// 1e-4 of the products) and the bytes are the rays, z (4 a point), the per-ray viewdir
// table, the weights and the maps: ≈ 3 MB a fine chunk, ≈ 1 us at 3.35 TB/s. The kernel
// is bound by its products, as K1 is.
//
// Design: K1's template with the compositing epilogue (CMP in fused_mlp_fwd.cuh). The
// embedding warps form the points o + d z and embed them; the consumers run K1's
// products and stage sigma (and the output columns) in shared memory; the embedding
// warps composite each staged tile in row order beside the next tile's products. The
// walk takes ray-aligned spans of tiles, so each ray lies in one block.

#include "fused_mlp_fwd.cuh"

namespace {

template <int CMP>
int launch_render(const float* rays_o, const float* rays_d, const float* z, const void* edr,
                  const void* wt, const float* biases, float* out, long long N, int S,
                  int span, const long long* plan, int n_sms, void* stream) {
  const float* rays[3] = {rays_o, rays_d, z};
  return launch_fused_mlp_fwd<ROWS_RAY_Z, CMP>(nullptr, edr, wt, biases, out, N * S, S, plan,
                                               nullptr, nullptr, n_sms, stream, rays, span);
}

}  // namespace

// `rays_o`, `rays_d` [N, 3] fp32 (no zero direction), `z` [N, S] fp32, `edr` the per-ray
// viewdir embedding [N, EDP] bf16; `wt` is pack_params's transposed weights and `plan`
// _fwd_plan's table cut after sigma; `span` the plan's tiles a span. Writes the weights
// [N, S] fp32.
extern "C" int dmnerf_fused_render_weights(const float* rays_o, const float* rays_d,
                                           const float* z, const void* edr, const void* wt,
                                           const float* biases, float* out, long long N, int S,
                                           int span, const long long* plan, int n_sms,
                                           void* stream) {
  return launch_render<CMP_WEIGHTS>(rays_o, rays_d, z, edr, wt, biases, out, N, S, span, plan,
                                    n_sms, stream);
}

// The same over _fwd_plan's whole table; writes the maps [N, 4 + C] fp32.
extern "C" int dmnerf_fused_render_maps(const float* rays_o, const float* rays_d,
                                        const float* z, const void* edr, const void* wt,
                                        const float* biases, float* out, long long N, int S,
                                        int span, const long long* plan, int n_sms,
                                        void* stream) {
  return launch_render<CMP_MAPS>(rays_o, rays_d, z, edr, wt, biases, out, N, S, span, plan,
                                 n_sms, stream);
}
