// K3: the fused PE + MLP forward with per-point directions embedded in the kernel,
// sm_90a. Replaces the JAX package's Pallas TPU kernel _fwd_kernel
// (dmnerf_tpu/kernels/fused_mlp.py:462), pe_mode 'kernel'; bound and design in
// fused_mlp_fwd.cuh.

#include "fused_mlp_fwd.cuh"

// `dirs` is [P, 3] fp32, one direction per point, embedded with multires_views octaves
// into the EDP columns of the viewdir embedding. `wt` is pack_params's transposed
// weights and `plan` _fwd_plan's table.
extern "C" int dmnerf_fused_mlp_fwd_kpe(const float* pts, const float* dirs, const void* wt,
                                        const float* biases, float* out, long long P,
                                        const long long* plan, void* stash,
                                        const long long* stash_table, int n_sms, void* stream) {
  return launch_fused_mlp_fwd<ROWS_POINT_DIRS>(pts, dirs, wt, biases, out, P, 1, plan, stash,
                                               stash_table, n_sms, stream);
}
