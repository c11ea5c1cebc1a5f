// K7: the standalone positional encoding of the points, sm_90a. Replaces the JAX
// package's Pallas TPU kernel make_pe_pallas.kernel (dmnerf_tpu/kernels/fused_mlp.py:689,
// pallas_call at :699), pe_mode 'outside': x [P, 3] fp32 -> e [P, width] bf16 with the
// lanes [x | sin(2^f x) freq-major | cos(2^f x) freq-major | 0 pad], the embedding that
// K5 (fused_mlp_fwd_pe.cu) and K6 (fused_mlp_bwd_pe.cu) read.
//
// Bounds, at the flagship's multires 10 and width 64, for a fine render chunk of 393,216
// points. Bytes: 12 in and 2 * width out a point, 55 MB over the card's 3.35 TB/s, 16.4
// us. Issue: 3 * multires accurate sincosf a point, each a few tens of instructions on
// its fast path (chip_smoke.py counts them in SASS), over 132 SMs x 4 schedulers x 32
// lanes a clock: about 12 us. The two are close, so the kernel must spend little beyond
// the sincosf and keep its stores off the threads that compute.
//
// Design. One thread per point; a block of TILE threads takes a tile of TILE points; a
// persistent grid of a few blocks an SM where block b walks tiles b, b + grid, ... The
// host's plan (_pe_plan in kernels/fused_mlp.py, from the occupancy query) gives the
// grid, the tiles, each tile's copy bytes and the block's staging bytes; the entry
// checks them against the kernel's tiling and the kernel walks and copies by them.
// - A thread loads its point's three coordinates with plain loads (x may be a slice,
//   4-byte aligned) and builds its row in registers: at the flagship's multires 10 and
//   width 64 the octave loop unrolled, no division, the exact phase x * 2^f, the
//   accurate sincosf (no fast math: the phases reach 2^9 |x|, thousands of radians at
//   far 9.5), round-to-nearest bf16 packed in pairs. That is bit for bit the embedding
//   embed_rows (fused_mlp_common.cuh) builds in K1 and K3, which the card tests and
//   chip_smoke.py hold it to. Where the point's top phase is below sincosf's slow-path
//   threshold (~1e5 rad: within 206 of the origin at multires 10), the compiler is told
//   so, and the 30 calls run without their range branches, interleaved; other points
//   take the calls as they are, slow path included.
// - It stages the row in shared memory as 16-byte chunks, chunk (q + t) mod chunks at
//   step q (its registers rotated first, one select a register for each bit of t mod
//   chunks): at 128-byte rows the eight threads of a quarter-warp hit distinct banks,
//   and the tile stays plain row-major.
// - One thread sends the tile's rows to e with one bulk copy (cp.async.bulk through the
//   TMA engine; rows past P are not sent), so no thread spends registers or issue slots
//   on the output. Two staging tiles a block: a tile's copy drains while the next
//   tile's sincosf run; one barrier a tile. The next tile's points are loaded before
//   this tile's sincosf, so their latency hides behind them.
// Any other (multires, width) takes the generic path: the same walk and copies, the
// row written into shared memory lane by lane.
//
// Measurement switches (scripts/fwd_anatomy_torch.py --k7): DMNERF_PE_NO_STORE (compute
// only: rows built, then folded into a value that is never stored in practice) and
// DMNERF_PE_STORE_ONLY (stores only: a fixed row of x, no sincosf) split the kernel's
// time.

#include <type_traits>

#include "fused_mlp_sm90.cuh"

namespace {

constexpr int TILE = 128;         // points a tile, threads a block
constexpr int STAGES = 2;         // staging tiles a block; one copy in flight
constexpr int MIN_BLOCKS = 4;     // the launch bound's blocks an SM (caps the registers)
constexpr int MAX_WIDTH = 256;
constexpr int UNROLLED_MR = 10;   // the multires whose octave loop is unrolled

// The width pack_params gives multires: its 3 (1 + 2 multires) lanes padded to 16.
__host__ __device__ constexpr int packed_width(int multires) {
  return (3 + 6 * multires + 15) / 16 * 16;
}

// One staging tile (TILE rows), the bytes of a full tile's copy.
constexpr size_t tile_bytes(int width) { return (size_t)TILE * width * sizeof(__nv_bfloat16); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// sincosf takes its slow path (Payne-Hanek reduction) at phases of this magnitude and
// above: its range check in SASS is |a| >= 105615.
constexpr float SLOW_PHASE = 105615.0f;

// The sin and cos lanes of one point into v. With FAST every phase is known to be below
// SLOW_PHASE and the compiler is told so: the same sincosf, without its range branch.
// That branch would end a basic block at each of the 3 MR calls; without it the
// scheduler interleaves them all.
template <int MR, bool FAST>
__device__ __forceinline__ void octaves(const float (&xs)[3], float (&v)[packed_width(MR)]) {
  constexpr int NF = 3 * MR;
#pragma unroll
  for (int f = 0; f < MR; ++f)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = xs[c] * (float)(1u << f);
      float s, co;
#ifdef DMNERF_PE_STORE_ONLY
      s = co = xs[c];
#else
      if constexpr (FAST) __builtin_assume(!(fabsf(a) >= SLOW_PHASE));
      sincosf(a, &s, &co);
#endif
      v[3 + 3 * f + c] = s;
      v[3 + NF + 3 * f + c] = co;
    }
}

// The row [x | sin(2^f x) | cos(2^f x) | 0 pad] of one point at multires MR, in bf16
// pairs: r[k] holds lane 2k in its low half and lane 2k + 1 in its high half.
template <int MR>
__device__ __forceinline__ void build_row(const float (&xs)[3],
                                          uint32_t (&r)[packed_width(MR) / 2]) {
  constexpr int NF = 3 * MR, W = packed_width(MR);
  float v[W];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = xs[c];
  // the top octave's phase bounds every phase of the point (2^f is exact)
  const float top = fmaxf(fabsf(xs[0]), fmaxf(fabsf(xs[1]), fabsf(xs[2]))) *
                    (float)(1u << (MR - 1));
  if (!(top >= SLOW_PHASE))
    octaves<MR, true>(xs, v);
  else
    octaves<MR, false>(xs, v);
#pragma unroll
  for (int j = 3 + 2 * NF; j < W; ++j) v[j] = 0.f;
#pragma unroll
  for (int k = 0; k < W / 2; ++k) r[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
}

// r's 16-byte chunks rotated by rot < NCH: chunk q takes chunk (q + rot) mod NCH.
template <int NCH>
__device__ __forceinline__ void rotate_chunks(uint32_t (&r)[4 * NCH], int rot) {
#pragma unroll
  for (int b = 1; b < NCH; b *= 2) {
    const bool on = rot & b;
    uint32_t t[4 * NCH];
#pragma unroll
    for (int i = 0; i < 4 * NCH; ++i) t[i] = r[(i + 4 * b) % (4 * NCH)];
#pragma unroll
    for (int i = 0; i < 4 * NCH; ++i) r[i] = on ? t[i] : r[i];
  }
}

// Thread t's row into row t of the staging tile, chunk (q + t) mod NCH at step q.
template <int MR>
__device__ __forceinline__ void stage_row(unsigned char* stage, int t, const float (&xs)[3]) {
  constexpr int NCH = packed_width(MR) / 8;
  uint32_t r[4 * NCH];
  build_row<MR>(xs, r);
  uint4* row = reinterpret_cast<uint4*>(stage) + t * NCH;
#ifdef DMNERF_PE_NO_STORE
  uint32_t fold = 0;
#pragma unroll
  for (int k = 0; k < 4 * NCH; ++k) fold ^= r[k];
  if (fold == 0x9e3779b9u) row[0].x = fold;
  return;
#endif
  const int rot = t % NCH;
  rotate_chunks<NCH>(r, rot);
  int c = rot;
#pragma unroll
  for (int q = 0; q < NCH; ++q) {
    row[c] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    c = c + 1 == NCH ? 0 : c + 1;
  }
}

// The generic path: any multires and width, lane by lane into shared memory (lanes
// in an order rotated by t, which spreads a warp's stores over the banks). 2^f is made
// from its exponent bits, exact for any octave.
__device__ __forceinline__ void stage_row_generic(unsigned char* stage, int t,
                                                  const float (&xs)[3], int multires,
                                                  int width) {
  __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(stage) + (size_t)t * width;
  const int nf = 3 * multires;
  for (int c = 0; c < 3; ++c) row[c] = __float2bfloat16(xs[c]);
  int j = t % nf;
  for (int k = 0; k < nf; ++k) {
    const int f = j / 3, c = j - 3 * f;
    float s, co;
    sincosf((c == 0 ? xs[0] : c == 1 ? xs[1] : xs[2]) * __int_as_float((127 + f) << 23), &s,
            &co);
    row[3 + j] = __float2bfloat16(s);
    row[3 + nf + j] = __float2bfloat16(co);
    j = j + 1 == nf ? 0 : j + 1;
  }
  for (int col = 3 + 2 * nf; col < width; ++col) row[col] = __float2bfloat16(0.f);
}

// Point p's coordinates into v, if p < P.
__device__ __forceinline__ void load_point(const float* __restrict__ x, long long p, long long P,
                                           float (&v)[3]) {
  if (p < P) {
    v[0] = x[3 * p];
    v[1] = x[3 * p + 1];
    v[2] = x[3 * p + 2];
  }
}

// MR = UNROLLED_MR: the unrolled row of packed_width(MR) lanes; 0: the generic path.
// Block b walks tiles b, b + gridDim.x, ... < tiles; tile i's copy sends copy_bytes
// (last_copy_bytes for the last tile) from its staging tile to byte i * copy_bytes of e.
// The staging tiles lie copy_bytes apart.
template <int MR>
__global__ void __launch_bounds__(TILE, MIN_BLOCKS)
fused_pe_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ e, long long P,
                int multires, int width, long long tiles, uint32_t copy_bytes,
                uint32_t last_copy_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  int s = 0;
  float xs[3] = {0.f, 0.f, 0.f};
  load_point(x, (long long)blockIdx.x * TILE + t, P, xs);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p = tile * TILE + t;
    unsigned char* stage = smem + (size_t)s * copy_bytes;
    float xn[3] = {0.f, 0.f, 0.f};
    load_point(x, p + (long long)gridDim.x * TILE, P, xn);   // the next tile's, in flight
    if (p < P) {
      if constexpr (MR > 0)
        stage_row<MR>(stage, t, xs);
      else
        stage_row_generic(stage, t, xs, multires, width);
    }
#ifndef DMNERF_PE_NO_STORE
    sm90::fence_proxy_async();
    // the copy issued STAGES - 1 tiles ago has read the staging tile that the next tile
    // writes after this barrier
    if (t == 0) sm90::bulk_wait_read<STAGES - 2>();
    __syncthreads();
    if (t == 0) {
      sm90::bulk_store(reinterpret_cast<unsigned char*>(e) + tile * copy_bytes, stage,
                       tile + 1 == tiles ? last_copy_bytes : copy_bytes);
      sm90::bulk_commit();
    }
#endif
    s = s + 1 == STAGES ? 0 : s + 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) xs[c] = xn[c];
  }
#ifndef DMNERF_PE_NO_STORE
  if (t == 0) sm90::bulk_wait_all<0>();
#endif
}

bool valid(int multires, int width) {
  return multires >= 1 && width % 8 == 0 && width >= 3 * (1 + 2 * multires) &&
         width <= MAX_WIDTH;
}

// Call f with std::integral_constant<int, MR>: MR = UNROLLED_MR where multires is
// UNROLLED_MR and width is packed_width(multires), else 0 (the generic path).
template <typename F>
int with_rows(int multires, int width, F f) {
  if (multires == UNROLLED_MR && width == packed_width(UNROLLED_MR))
    return f(std::integral_constant<int, UNROLLED_MR>{});
  return f(std::integral_constant<int, 0>{});
}

// Dynamic shared memory above 48 KB (the generic path's widest rows) must be allowed.
template <int MR>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_pe_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Blocks of the kernel for (multires, width) that fit on one SM, or minus a cudaError.
extern "C" int dmnerf_fused_pe_blocks_per_sm(int multires, int width) {
  if (!valid(multires, width)) return -(int)cudaErrorInvalidValue;
  return with_rows(multires, width, [&](auto mr) {
    constexpr int MR = decltype(mr)::value;
    const size_t smem = STAGES * tile_bytes(width);
    int n = 0;
    cudaError_t err = allow_smem<MR>(smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_pe_kernel<MR>, TILE, smem);
    return err == cudaSuccess ? n : -(int)err;
  });
}

// Launch the plan (_pe_plan): `grid` blocks of `tile` threads, `staging_bytes` of shared
// memory a block, `tiles` tiles copied by `copy_bytes` (`last_copy_bytes` the last), on
// `stream`. Returns cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a plan that is not this kernel's tiling. `width` is a
// multiple of 8, at least 3 * (1 + 2 * multires) and at most 256; e is 16-byte aligned.
extern "C" int dmnerf_fused_pe(const float* x, void* e, long long P, int multires, int width,
                               int tile, long long tiles, long long copy_bytes,
                               long long last_copy_bytes, long long staging_bytes, int grid,
                               void* stream) {
  if (P <= 0 || !valid(multires, width) || reinterpret_cast<uintptr_t>(e) % 16)
    return (int)cudaErrorInvalidValue;
  const long long rows = P - (tiles - 1) * TILE;
  if (tile != TILE || tiles != (P + TILE - 1) / TILE || grid < 1 || grid > tiles ||
      copy_bytes != (long long)tile_bytes(width) || last_copy_bytes != rows * width * 2 ||
      staging_bytes != STAGES * copy_bytes)
    return (int)cudaErrorInvalidValue;
  return with_rows(multires, width, [&](auto mr) {
    constexpr int MR = decltype(mr)::value;
    const cudaError_t err = allow_smem<MR>((size_t)staging_bytes);
    if (err != cudaSuccess) return (int)err;
    fused_pe_kernel<MR><<<(unsigned)grid, tile, (size_t)staging_bytes, (cudaStream_t)stream>>>(
        x, reinterpret_cast<__nv_bfloat16*>(e), P, multires, width, tiles,
        (uint32_t)copy_bytes, (uint32_t)last_copy_bytes);
    return (int)cudaGetLastError();
  });
}
