// K12: a training bundle's instance channels, sm_90a. Replaces no TPU kernel: the JAX
// package leaves the instance map (dmnerf_tpu/core/compositor.py composite) and the
// emptiness penalizer (dmnerf_tpu/objfield/penalizer.py) to XLA, which fuses them. In
// PyTorch the same work was about thirty elementwise and reduction passes over [N, S, C']
// tensors and their autograd backward (the sigmoid, two clamps and two logs, the air
// one-hot products, the zero-filled slices of raw and the adds that join them).
//
// Per ray n, with x = raw[n, s, 4 + c] (C' = ins_num + 1 columns, air last), w the
// detached compositing weights, z the samples, depth the detached depth, |d| the ray
// direction's norm, sigma(x) = 1 / (1 + exp(-x)) and clamp(v) = max(v, 1e-8):
//
//   forward   logits[n, c] = sum_s w x, and with the penalizer, over the ray's samples,
//             sums[n] = (sum_before = sum w_before(s) * (c < C'-1 ? -log clamp(1 - sigma)
//                                                               : -log clamp(sigma)),
//             n_before = sum before(s), sum_middle = sum w_middle(s) * -log clamp(1 -
//             sigma_air), n_middle = sum middle(s)); p = z |d|, before = p < (depth - tol)
//             |d|, after = p > (depth + tol) |d|, middle = 1 - (after + before),
//             g = exp(-(depth |d| - p)^2 / (2 deta_w^2)) / (0.4 sqrt(2 pi)) + 1e-8,
//             w_before = (1 - g) before, w_middle = g middle
//             (objfield/penalizer.py penalizer_sums, the plain version; the caller sums
//             the rays' sums).
//   backward  d_raw[n, s, :4] = 0, d_raw[n, s, 4 + c] = w g_logits[n, c] + the
//             penalizer's term with the cotangents gb, gm of the ray's sum_before and
//             sum_middle (the counts have none): gb w_before sigma (c < C'-1), and for air
//             -gb w_before (1 - sigma) + gm w_middle sigma, the derivatives of -log sigma
//             and -log(1 - sigma) through sigmoid in closed form. Each term is gated
//             where the plain path's clamp of its log's argument is active (sigma < 1e-8
//             or 1 - sigma < 1e-8), so saturated logits get the plain path's zero.
//
// sigma, 1 - sigma, the point terms and their operations are the plain path's, in its
// fp32 operations on the card (the scalars come as the reciprocals PyTorch multiplies by),
// so the masks and the gates agree with it exactly; the sums are taken in another order,
// and the backward's closed form rounds once where the plain chain rounds three times.
//
// Bound: bytes. The forward reads raw's instance columns, w and z and writes the logits
// and the sums; the backward reads them again with g_logits and writes d_raw whole: for DM-SR's fine
// bundle (3072 x 192 points, C' = 33) 0.18 GB, 0.05 ms at 3.35 TB/s. One exp, and one or
// two logs, per entry are far below that.
//
// Design. A persistent grid (as many blocks of 256 threads as the SMs hold at once) walks
// the rays, a block a ray at a time. The block first puts the ray's point terms in shared
// memory (w, and with the penalizer w_before and w_middle, or in the backward their
// products with the cotangents), one thread a point, so each exp of a point is taken
// once. Then G = 256 / C' rows of the ray at a time: thread t takes column t % C' of row
// t / C' (the forward reads the instance columns; the backward writes every column of
// the row, t % R), so a warp reads and writes consecutive words; four rows ahead are
// loaded before any is used. The forward sums each column over its rows in registers,
// then over the G row groups in order in shared memory; the penalizer's four terms of
// each thread are summed over a warp by halving exchanges and over the warps in order in
// shared memory, into the ray's row of sums: no float atomics and no host read, so a
// launch on the same inputs gives the same bits and a CUDA graph can hold it. Nothing is
// kept between the passes: the backward recomputes sigma and the point terms from raw, z,
// depth and |d|.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int AHEAD = 4;          // rows of a thread loaded before any is used
constexpr int MAX_S = 16384;      // up to three [S] arrays of shared memory
constexpr float LOG_FLOOR = 1e-8f;

struct Point {
  float tol, inv_two_dw2, inv_gnorm;   // tolerance, 1 / (2 deta_w^2), 1 / (0.4 sqrt(2 pi))
};

// The plain path's clamp(v, min=1e-8): NaN stays NaN.
__device__ __forceinline__ float clamp_floor(float v) { return v < LOG_FLOOR ? LOG_FLOOR : v; }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The point terms of sample z on a ray: before and middle as 0 / 1 (middle may read -1
// only where a negative tolerance makes before and after both hold), and the weights of
// the two BCE sums, as penalizer_sums computes them.
__device__ __forceinline__ void point_terms(const Point& pt, float z, float depth, float norm,
                                            float& before, float& middle, float& w_before,
                                            float& w_middle) {
  const float p = z * norm;
  before = p < (depth - pt.tol) * norm ? 1.0f : 0.0f;
  const float after = p > (depth + pt.tol) * norm ? 1.0f : 0.0f;
  middle = 1.0f - (after + before);
  const float delta = depth * norm - p;
  const float gauss = expf(-(delta * delta) * pt.inv_two_dw2) * pt.inv_gnorm + 1e-8f;
  w_before = (1.0f - gauss) * before;
  w_middle = gauss * middle;
}

// One entry of the forward: x's term of its column's logit, and its term of sum_before,
// -log clamp(sigma) for air and -log clamp(1 - sigma) for the rest (one log a lane).
template <bool PENALIZE>
__device__ __forceinline__ void fwd_entry(float x, float w, float w_before, bool air,
                                          float& acc, float& sb) {
  acc += w * x;
  if (PENALIZE) {
    const float sig = sigmoid(x);
    sb += -logf(clamp_floor(air ? sig : 1.0f - sig)) * w_before;
  }
}

// Shared memory: pw[S], pb[S] (the point terms), the forward's column sums cs[G][C'] and
// the warps' penalizer sums red[4][WARPS]. A thread of the point terms also takes the
// point's sum_middle term from the air logit, so no lane of the rows takes a second log.
template <bool PENALIZE>
__global__ void __launch_bounds__(THREADS)
instance_terms_fwd_kernel(const float* __restrict__ raw, const float* __restrict__ w,
                          const float* __restrict__ z, const float* __restrict__ depth,
                          const float* __restrict__ norm, int N, int S, int C, Point pt,
                          float* __restrict__ logits, float* __restrict__ sums) {
  extern __shared__ float smem[];
  float* pw = smem;
  float* pb = pw + S;
  float* cs = pb + S;
  const int R = 4 + C;
  const int G = THREADS / C;
  float* red = cs + G * C;
  const int t = threadIdx.x;
  const bool active = t < G * C;
  const int g = t / C, c = t % C;
  const bool air = c == C - 1;

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const float dn = depth[n], nn = norm[n];
    const float* ray = raw + (size_t)n * S * R;
    float sb = 0.0f, sm = 0.0f, nb = 0.0f, nm = 0.0f;
    for (int s = t; s < S; s += THREADS) {
      pw[s] = w[(size_t)n * S + s];
      if (PENALIZE) {
        float before, middle, w_middle;
        point_terms(pt, z[(size_t)n * S + s], dn, nn, before, middle, pb[s], w_middle);
        nb += before;
        nm += middle;
        const float air_x = __ldg(ray + (size_t)s * R + 4 + C - 1);
        sm += -logf(clamp_floor(1.0f - sigmoid(air_x))) * w_middle;
      }
    }
    __syncthreads();
    float acc = 0.0f;
    if (active) {
      const float* col = ray + 4 + c;
      int s0 = g;
      for (; s0 + (AHEAD - 1) * G < S; s0 += AHEAD * G) {
        float x[AHEAD];
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) x[u] = __ldg(col + (size_t)(s0 + u * G) * R);
#pragma unroll
        for (int u = 0; u < AHEAD; ++u)
          fwd_entry<PENALIZE>(x[u], pw[s0 + u * G], pb[s0 + u * G], air, acc, sb);
      }
      for (; s0 < S; s0 += G)
        fwd_entry<PENALIZE>(__ldg(col + (size_t)s0 * R), pw[s0], pb[s0], air, acc, sb);
      cs[g * C + c] = acc;
    }
    if (PENALIZE) {
      float v[4] = {sb, nb, sm, nm};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) v[q] += __shfl_xor_sync(0xffffffffu, v[q], k);
        if (t % 32 == 0) red[q * WARPS + t / 32] = v[q];
      }
    }
    __syncthreads();
    if (t < C) {
      float v = 0.0f;
      for (int i = 0; i < G; ++i) v += cs[i * C + t];
      logits[(size_t)n * C + t] = v;
    } else if (PENALIZE && t < C + 4) {
      const int q = t - C;
      float v = 0.0f;
      for (int i = 0; i < WARPS; ++i) v += red[q * WARPS + i];
      sums[(size_t)n * 4 + q] = v;
    }
  }
}

// One entry of the backward: w g_logit, and with the penalizer the derivatives of
// -log sigma (air: -(1 - sigma)) and -log(1 - sigma) (sigma) through sigmoid, each gated
// where the plain path's clamp of its log's argument is active. a is the cotangent of
// sum_before times w_before, m that of sum_middle times w_middle (air lanes only, zero
// elsewhere), so every lane runs the same instructions.
template <bool PENALIZE>
__device__ __forceinline__ float bwd_entry(float x, float w_gl, float a, float m, bool air) {
  float dx = w_gl;
  if (PENALIZE) {
    const float sig = sigmoid(x);
    const float one_minus = 1.0f - sig;
    dx += (air ? sig : one_minus) >= LOG_FLOOR ? a * (air ? -one_minus : sig) : 0.0f;
    dx += one_minus >= LOG_FLOOR ? m * sig : 0.0f;
  }
  return dx;
}

// Shared memory: pw[S], pa[S], pm[S]: w, and the cotangents of the two BCE sums times
// their point weights.
template <bool PENALIZE>
__global__ void __launch_bounds__(THREADS)
instance_terms_bwd_kernel(const float* __restrict__ raw, const float* __restrict__ w,
                          const float* __restrict__ z, const float* __restrict__ depth,
                          const float* __restrict__ norm, const float* __restrict__ g_logits,
                          const float* __restrict__ g_sums, int N, int S, int C, Point pt,
                          float* __restrict__ d_raw) {
  extern __shared__ float smem[];
  float* pw = smem;
  float* pa = pw + S;
  float* pm = pa + S;
  const int R = 4 + C;
  const int G = THREADS / R;
  const int t = threadIdx.x;
  const bool active = t < G * R;
  const int g = t / R, col = t % R, c = col - 4;
  const bool air = c == C - 1;
  // the columns of rgb and sigma (c < 0) take no gradient here: zeros, written by the
  // same stores as the instance columns beside them
  const bool ins = c >= 0;

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const float dn = depth[n], nn = norm[n];
    const float gb = PENALIZE ? g_sums[(size_t)n * 4] : 0.0f;
    const float gm = PENALIZE ? g_sums[(size_t)n * 4 + 2] : 0.0f;
    __syncthreads();                  // the last ray's rows are done with the point terms
    for (int s = t; s < S; s += THREADS) {
      pw[s] = w[(size_t)n * S + s];
      if (PENALIZE) {
        float before, middle, w_before, w_middle;
        point_terms(pt, z[(size_t)n * S + s], dn, nn, before, middle, w_before, w_middle);
        pa[s] = gb * w_before;
        pm[s] = gm * w_middle;
      }
    }
    __syncthreads();
    if (!active) continue;
    const size_t base = (size_t)n * S * R + col;
    const float gl = ins ? g_logits[(size_t)n * C + c] : 0.0f;
    const float a_on = ins ? 1.0f : 0.0f, m_on = air ? 1.0f : 0.0f;
    int s0 = g;
    for (; s0 + (AHEAD - 1) * G < S; s0 += AHEAD * G) {
      float x[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        x[u] = ins ? __ldg(raw + base + (size_t)(s0 + u * G) * R) : 0.0f;
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int s = s0 + u * G;
        d_raw[base + (size_t)s * R] =
            bwd_entry<PENALIZE>(x[u], pw[s] * gl, a_on * pa[s], m_on * pm[s], air);
      }
    }
    for (; s0 < S; s0 += G) {
      const float x = ins ? __ldg(raw + base + (size_t)s0 * R) : 0.0f;
      d_raw[base + (size_t)s0 * R] =
          bwd_entry<PENALIZE>(x, pw[s0] * gl, a_on * pa[s0], m_on * pm[s0], air);
    }
  }
}

size_t fwd_smem(int S, int C) {
  return (2 * (size_t)S + (size_t)(THREADS / C) * C + 4 * WARPS) * sizeof(float);
}
size_t bwd_smem(int S) { return 3 * (size_t)S * sizeof(float); }

// The persistent grid: as many blocks as the SMs hold at once (its registers and shared
// memory decide), at most one a ray. Sets the kernel's shared memory above 48 KB first.
int grid_for(const void* kernel, int N, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const int err =
      (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err) return err;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = N < most ? N : most;
  return 0;
}

}  // namespace

extern "C" {

// Forward: raw [N, S, 4 + C] and w, z [N, S], depth, norm [N] (fp32, contiguous) ->
// logits [N, C], and with penalize the rays' sums [N, 4].
int dmnerf_instance_terms_fwd(const float* raw, const float* w, const float* z,
                              const float* depth, const float* norm, int N, int S, int C,
                              int penalize, float tol, float inv_two_dw2, float inv_gnorm,
                              float* logits, float* sums, void* stream) {
  if (N < 1 || S < 1 || S > MAX_S || C < 1 || 4 + C > THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(S, C);
  const void* kernel = penalize ? (const void*)instance_terms_fwd_kernel<true>
                                : (const void*)instance_terms_fwd_kernel<false>;
  int blocks = 0;
  const int err = grid_for(kernel, N, smem, &blocks);
  if (err) return err;
  const Point pt{tol, inv_two_dw2, inv_gnorm};
  if (penalize)
    instance_terms_fwd_kernel<true><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        raw, w, z, depth, norm, N, S, C, pt, logits, sums);
  else
    instance_terms_fwd_kernel<false><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        raw, w, z, depth, norm, N, S, C, pt, logits, sums);
  return (int)cudaGetLastError();
}

// Backward: the forward's inputs, g_logits [N, C] and g_sums [N, 4] (the cotangents of the
// forward's sums; the counts' are not read) -> d_raw [N, S, 4 + C].
int dmnerf_instance_terms_bwd(const float* raw, const float* w, const float* z,
                              const float* depth, const float* norm, const float* g_logits,
                              const float* g_sums, int N, int S, int C, int penalize, float tol,
                              float inv_two_dw2, float inv_gnorm, float* d_raw, void* stream) {
  if (N < 1 || S < 1 || S > MAX_S || C < 1 || 4 + C > THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(S);
  const void* kernel = penalize ? (const void*)instance_terms_bwd_kernel<true>
                                : (const void*)instance_terms_bwd_kernel<false>;
  int blocks = 0;
  const int err = grid_for(kernel, N, smem, &blocks);
  if (err) return err;
  const Point pt{tol, inv_two_dw2, inv_gnorm};
  if (penalize)
    instance_terms_bwd_kernel<true><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        raw, w, z, depth, norm, g_logits, g_sums, N, S, C, pt, d_raw);
  else
    instance_terms_bwd_kernel<false><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        raw, w, z, depth, norm, g_logits, g_sums, N, S, C, pt, d_raw);
  return (int)cudaGetLastError();
}

}  // extern "C"
