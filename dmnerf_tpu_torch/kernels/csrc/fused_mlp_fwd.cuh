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
//  * fused_render.cu (K8c, K8f) runs K1's walk over points it forms from the rays and
//    composites the raw output along each ray (CMP, below).
//  * head512.cu (K9) and heads_fused.cu (K10) run the walk over a hidden activation and
//    a layer table of their own (ROWS_H, below): the JAX package's head probes.
// K1, K3 and K5 differ only in how a tile's embeddings are built (Rows). What they compute
// is set out in dmnerf_tpu_torch/kernels/fused_mlp.py, whose fused_query_ref /
// fused_query_kpe_ref / fused_query_pe_ref are their plain versions, whose pack_params
// builds the weights they read (wt, each layer's block transposed) and whose _fwd_plan
// builds the table below.
//
// Bound. Per fine point of the flagship model (D=8, W=256, ins_num 32) the layers
// execute 564,864 multiply-accumulates, 1.13 MFLOP, against 4 * (3 + 3) bytes in (K3;
// K1 reads 12 + 64 / S, K5 2 * (64 + 32)) and 37 * 4 bytes out: at least 3,300 FLOP
// per byte, far above the card's 295 bf16 FLOP/byte. The kernel is bound by its
// executed FLOPs over the 989 TFLOP/s bf16 tensor-core peak. The weights (≈ 1.16 MB
// bf16) do not fit in shared memory and stream from L2 once per pair of 128-point
// tiles (below): ≈ 4.7 KB of L2 reads a point, ≈ 1.85 GB for a fine render chunk of
// 393,216 points, 240 FLOP per L2 byte. One block per tile would read twice that, and
// L2 then caps the products: the 8-layer chain probe of scripts/fwd_anatomy_torch.py
// read its weights at 5.1–5.6 TB/s without epilogues (H100 80GB HBM3 at 700 W).
//
// Design: a persistent grid of clusters of two blocks, one block of three warpgroups per
// SM; a cluster walks pairs of 128-point tiles, one tile a block.
//  * Two consumer warpgroups own 64 points each and run every product as wgmma with
//    fp32 accumulators in registers. A hidden activation never leaves registers: a
//    layer's accumulator gets its bias and ReLU, is cast to bf16 and is exactly the
//    next product's A fragment (the m64nNk16 accumulator layout is the A fragment
//    layout), so the trunk, sigma, the head and the output read h from registers.
//  * The embeddings e (point, EP <= 64 columns) and ed (viewdir, EDP <= 64) of a tile
//    are [128][64] bf16 tiles in shared memory with 128-byte swizzle; they enter the
//    emb0, split and head products as shared-memory A operands of the same
//    accumulation.
//  * B is the layer's weight block transposed ([N][K], K contiguous: pack_params's wt),
//    the K-major operand wgmma takes for any N that is a multiple of 8; the stored
//    [K][N] block would be an MN-major operand, whose 128-byte swizzle atom is 64
//    columns of N wide, which the 16-column sigma and output layers are not. One
//    producer thread a block walks the plan's chunk list (a box of up to 256 rows of N
//    x 64 columns of K per chunk, one per A segment of 64 columns) into a 4-stage
//    mbarrier ring: each block's producer loads half of the box's rows with TMA
//    multicast into the same stage of both blocks, and a stage is refilled once the
//    consumers of both blocks have released it. Columns of K or rows of N outside a
//    segment arrive as zeros.
//  * The instruction width follows the layer's N at run time from a small set: one
//    n256, one to three n64, or one n16 per k-step, so the sigma layer, the 16- to
//    48-column output layers and the stubs' narrow heads do not pay for n256.
//  * The third warpgroup: its first warp issues the weight boxes; the other three
//    build the next tile's embeddings into the second of two embedding buffers while
//    the consumers run the products of this one (K1: the point embedding with the
//    exact-phase fp32 sincosf of embed_rows and the per-ray ed rows; K3: both
//    embeddings; K5: one thread loads both tiles with TMA). setmaxnreg gives the
//    consumers 232 registers and this warpgroup 40.
//  * Sigma is a layer of its own ([W, 16], column 0) kept in fp32 in registers; the
//    output layer writes it into column 3.
//  * Rows past the ragged tail compute on zeros and are never stored.
//  * The schedule of the consumers' products (SCHED, a template parameter). Under
//    SCHED_LOCKSTEP each layer runs at the narrowest instruction width that covers it
//    (n16, n64 one to three times, n256); ptxas then serializes every wgmma of the
//    kernel, each waiting for the one before. SCHED_PIPELINED runs every layer at one of
//    two widths, which ptxas pipelines (below). The rows each warpgroup owns, each
//    product's inputs and the order of every sum are the same under both, so their
//    outputs are equal bit for bit. K8f and K10 take SCHED_PIPELINED (PERF.md).
// Shared memory: 4 weight stages of 32 KB (128 KB) + 2 x (e, ed) tiles of 16 KB (64 KB)
// + 12 mbarriers, 193 KB with the 1 KB alignment slack, of the 227 KB a block can have;
// with STASH also two 16 KB staging tiles, 225 KB; with ROWS_H two 16 KB ed tiles, 225 KB.
//
// Training. With STASH the same kernel is the training forward: it also stores what
// the parameter backward (fused_mlp_bwd.cuh) reads, in the layout of fused_mlp.py's
// _bwd_plan: the point embedding and the per-point viewdir embedding as the embedding
// warps made them (K1, K3; K5's come from its inputs), and every ReLU output (the trunk layers
// and the head) as the bf16 values the next layer reads. The epilogue writes them, 128
// columns at a time, into a swizzled staging tile of its warpgroup, and the warpgroup
// copies its 64 rows of those columns out to the [P, N] stash block with 16-byte loads
// and streaming stores, two 256-byte row halves a warp instruction, while the other
// warpgroup's products run. The products and the output are the same code, so raw is
// bit for bit the render path's. Without STASH the added code compiles away.
//
// Rendering (CMP, K8c and K8f of fused_render.cu). The rows of a query are the samples
// of rays, S a ray, and the kernel composites them into the ray's weights [N, S]
// (CMP_WEIGHTS, with the layer table cut after sigma) or maps [N, 4+C] (CMP_MAPS:
// rgb, depth, sigmoid of the weighted instance logits), so raw never leaves the SM.
//  * The walk follows rays: a block takes spans of `span` consecutive tiles (the host's
//    plan: span * 128 points hold whole rays) and walks each span's tiles in order; the
//    two blocks of a cluster take neighbouring spans. Without CMP a span is one tile
//    and the walk is the one above.
//  * The consumers stage sigma (and under CMP_MAPS the output columns) of each tile in
//    fp32 in shared memory and go on to the next tile; the embedding warps, after
//    building the next tile's embeddings, composite the staged tile in row order: alpha
//    and log(1 - alpha) a row, the exclusive scan along each ray in one warp (a
//    segmented shuffle scan, the log-transmittance of a ray carried from the tile
//    before), the weights, and under CMP_MAPS one thread a column summing w * value
//    over the rows of each ray in order. Fixed-order sums, no atomics. The compositing
//    runs beside the next tile's products, off the tensor cores' path.
//  * The embedding warps form the points o + d z with round-to-nearest products and
//    sums, no contraction: the points, and so raw, are bit for bit those of K1 on the
//    points the plain path forms.
//
// Head probes (ROWS_H; K9, K10). The rows are a hidden activation x [P, 256] bf16: the
// first embedding thread loads a tile of it with TMA into the four 64-column tiles of
// the embedding buffers (one 64 KB buffer); each consumer warpgroup takes its 64 rows
// into the A fragments that chain the activations and releases the tile at once, so the
// next tile loads under this one's products. The other embedding warps transpose the
// tile's columns of edT [E, P] (K10) into an ed tile of their own (two buffers). The
// table is the host's (head_probes.py's _probe_plan, launch_head_probe): ReLU layers
// and sigma as above, sigma as a CUDA-core dot of the registers' h with a weight row
// (EPI_DOT), and EPI_COLS layers whose columns (one of them may take sigma's place) go
// to an output window [P, pitch] or into a row sum, reduced over the accumulator's quad
// by shuffles in a fixed order. A layer may read half of h (SEG_H_LO, SEG_H_HI: two of
// its four 64-column chunks). A head wider than 256 is several such layers over the same
// h, whose epilogues leave the registers as they are.
#pragma once

#include <type_traits>

#include "fused_mlp_common.cuh"
#include "fused_mlp_sm90.cuh"

namespace {

using namespace dmnerf;
using namespace sm90;

constexpr int FWG = 128;                       // threads of a warpgroup
constexpr int F_CONSUMERS = 2 * FWG;           // two consumer warpgroups, 64 points each
constexpr int F_THREADS = F_CONSUMERS + FWG;   // and the producer / embedding warpgroup
constexpr int FT = 128;                        // points per tile
constexpr int EMB_THREADS = FWG - 32;          // warps 1-3 of the third warpgroup
constexpr uint32_t F_STAGE_BYTES = 256 * 128;  // a weight box: <= 256 rows of N x 64 of K
constexpr uint32_t EMB_BYTES = FT * 128;       // an embedding tile, [128][64] bf16
constexpr uint32_t STG_BYTES = 64 * 256;       // a warpgroup's stash staging tile, [64][128]
constexpr int F_STAGES = 4;
constexpr int MAX_FMAPS = 2 * MAX_LAYERS;
constexpr int MAX_FCHUNKS = 7 * MAX_LAYERS;

// The consumers' schedule (see the design notes above): SCHED_PIPELINED runs every layer
// at one of two instruction widths, n256, or one n64 for a layer of at most 64 columns,
// so that ptxas pipelines each warpgroup's products (beside n16 and two or three n64 a
// k-step it serializes every wgmma of the kernel, C7511). The wider instruction reads
// stage rows past the layer's box into accumulator columns at or past its N, which no
// epilogue reads (the launchers refuse a table whose output columns pass N). A launcher
// whose schedule is not given takes lockstep; a measurement build with
// DMNERF_FWD_SCHED=1 gives every such launcher the pipelined one instead.
enum Sched { SCHED_LOCKSTEP = 0, SCHED_PIPELINED = 1 };
#ifdef DMNERF_FWD_SCHED
constexpr int FWD_DEFAULT_SCHED = DMNERF_FWD_SCHED;
#else
constexpr int FWD_DEFAULT_SCHED = SCHED_LOCKSTEP;
#endif

// DMNERF_FWD_STAMPS (a measurement build): every consumer warp and embedding warp sums
// the clock cycles of its parts of the walk in a row of its own in shared memory (not
// in registers, which the consumers have none to spare for), and the launch adds them
// into g_fwd_stamps, which dmnerf_fwd_stamps reads; without it the stamps compile away.
enum Stamp {
  ST_WALK = 0,   // consumers: the whole walk
  ST_FULL,       // ring_take's wait for a box (ring starvation)
  ST_PACE,       // wgmma.wait_group 1 after each chunk (the products' own pace)
  ST_DRAIN,      // wgmma.wait_group 0 at a layer's end
  ST_EPI,        // the epilogues, without the hand-off waits inside them
  ST_HANDOFF,    // waits for the embedding warps: emb_full, x_full, cb.empty
  ST_TILES,      // tiles walked (a count, not cycles)
  ST_E_WALK,     // embedding warps: the whole walk
  ST_E_BUILD,    // building a tile's embeddings (points, sincosf, ed, edT)
  ST_E_WAIT,     // waits for the consumers: emb_empty, x_empty
  ST_E_CMP,      // compositing a staged tile, its wait on cb.full included
  ST_E_CMPWAIT,  // the wait on cb.full alone
  ST_E_TILES,    // tiles walked
  ST_WARPS,      // consumer warps that reported
  ST_E_WARPS,    // embedding warps that reported
  N_STAMPS
};
#ifdef DMNERF_FWD_STAMPS
constexpr size_t STAMP_BYTES = (F_THREADS / 32) * N_STAMPS * 4;   // a row a warp
__device__ unsigned long long g_fwd_stamps[N_STAMPS];
__device__ __forceinline__ uint32_t stamp_clock() {
  uint32_t c;
  asm volatile("mov.u32 %0, %%clock;\n" : "=r"(c)::"memory");
  return c;
}
// ACC is a word of the warp's row; all lanes add to it, and one lane's time stays
#define DM_TIMED(ACC, ...)                   \
  do {                                       \
    const uint32_t t0_ = stamp_clock();      \
    __VA_ARGS__;                             \
    (ACC) += stamp_clock() - t0_;            \
  } while (0)
#define DM_STAMP_START(T) const uint32_t T = stamp_clock()
#define DM_STAMP_ADD(ACC, T) (ACC) += stamp_clock() - (T)
// lane 0 of a warp adds its row's sums [first, first + n) into g_fwd_stamps, then a
// count of the warps that reported at count_at
__device__ __forceinline__ void stamps_flush(const uint32_t* row, int first, int n, int count_at,
                                             int lane) {
  __syncwarp();
  if (lane == 0) {
    for (int i = first; i < first + n; ++i)
      atomicAdd(&g_fwd_stamps[i], (unsigned long long)row[i]);
    atomicAdd(&g_fwd_stamps[count_at], 1ull);
  }
}
#else
constexpr size_t STAMP_BYTES = 0;
#define DM_TIMED(ACC, ...) \
  do {                     \
    __VA_ARGS__;           \
  } while (0)
#define DM_STAMP_START(T) \
  do {                    \
  } while (0)
#define DM_STAMP_ADD(ACC, T) \
  do {                       \
  } while (0)
#endif

// What the kernel makes of raw: raw itself, or the rays' weights or maps (fused_render.cu)
enum Cmp { CMP_NONE = 0, CMP_WEIGHTS = 1, CMP_MAPS = 2 };
constexpr int CMP_PITCH = 53;   // staged output columns a row: c4 <= 53, odd (no bank conflict)
// the compositing buffers: the tile's points [128][3]; sigma, alpha, log(1 - alpha), z
// and the weights a row; under CMP_MAPS the output columns and a carried sum a column
template <int CMP>
__host__ __device__ constexpr size_t cmp_smem() {
  return CMP == CMP_NONE ? 0
                         : FT * 3 * 4 + 5 * FT * 4 +
                               (CMP == CMP_MAPS ? (size_t)FT * CMP_PITCH * 4 + 64 * 4 : 0);
}

// The mbarriers: the ring's full and empty, the embedding buffers' full and empty, CMP's
// or ROWS_H's hand-off pair.
template <int CMP, Rows ROWS>
__host__ __device__ constexpr int fwd_barriers() {
  return 2 * F_STAGES + 4 + (CMP != CMP_NONE || ROWS == ROWS_H ? 2 : 0);
}

// Shared memory: the ring, two (e, ed) embedding buffers (ROWS_H: the x tile), ROWS_H's
// two ed tiles, the staging tiles, the compositing buffers, mbarriers, the stamps' rows.
template <bool STASH, int CMP = CMP_NONE, Rows ROWS = ROWS_RAY_TABLE>
constexpr size_t fwd_smem() {
  return 1024 + (size_t)F_STAGES * F_STAGE_BYTES + 4 * (size_t)EMB_BYTES +
         (ROWS == ROWS_H ? 2 * (size_t)EMB_BYTES : 0) + (STASH ? 2 * (size_t)STG_BYTES : 0) +
         cmp_smem<CMP>() + fwd_barriers<CMP, ROWS>() * 8 + STAMP_BYTES;
}

// EPI_COLS and EPI_DOT: the head probes' (ROWS_H) columns and CUDA-core sigma
enum Epilogue { EPI_RELU = 0, EPI_SIGMA = 1, EPI_OUT = 2, EPI_COLS = 3, EPI_DOT = 4 };
// a layer's A segments, in the order of its chunks (SEG_H_LO / SEG_H_HI: ROWS_H only)
enum Seg { SEG_ED = 1, SEG_E_FIRST = 2, SEG_H = 4, SEG_E_LAST = 8, SEG_H_LO = 16, SEG_H_HI = 32 };
// what a head-probe walk writes: columns [P, pitch], or their row sum [P]
enum HeadOut { OUT_COLS = 0, OUT_ROWSUM = 1 };
// instruction widths per k-step: n256; n16; 1-3 x n64
enum Cls { CLS_256 = 0, CLS_16, CLS_64x1, CLS_64x2, CLS_64x3, N_CLS };

struct FLayer {
  int segs, cls, N, b_off, epi;
  long long stash_off;   // its ReLU output's stash block [P, N], -1 for none
};

// A weight box: map `map` at K column k0, 2 * half rows of 128 bytes; each block of the
// cluster loads `half` of its rows and multicasts them to both.
struct FChunk {
  int map, k0, half;
};

// A head-probe layer's output (ROWS_H): its first o_n columns go to output column o_col
// on (or into the row sum), column sig_col (or none, -1) taking sigma's value; a sigma
// layer (EPI_SIGMA, EPI_DOT) writes its one column when o_n is 1.
struct FHeadOut {
  int o_col, o_n, sig_col;
};

struct FwdParams {
  CUtensorMap maps[MAX_FMAPS];
  CUtensorMap e_map, ed_map;   // K5: its input embeddings [P, EP], [P, EDP]
  FLayer layers[MAX_LAYERS];
  FChunk chunks[MAX_FCHUNKS];
  const float *ray_o, *ray_d, *ray_z;   // K8: the rays [N, 3], [N, 3] and depths [N, S]
  long long P, e_stash, ed_stash;
  int n_layers, n_chunks, n_tiles, S, multires, multires_views, ep, edp, c4;
  int span, n_spans;   // the walk: tiles a span (1 without CMP), spans
  // ROWS_H: x [P, 256] is e_map's; edT [edt_rows, P] (or null); the layers' outputs
  const unsigned short* edt;
  int edt_rows, o_kind, o_pitch;
  FHeadOut hout[MAX_LAYERS];
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The stash staging tile of a warpgroup: 64 rows of 256 bytes (128 columns), the
// 16-byte chunk q of row r at chunk q ^ (r mod 8) of its group of 8, so that the
// epilogue's writes (8 rows a warp instruction) and the copy-out's reads (two row halves
// a warp instruction) meet no bank conflict.
__device__ __forceinline__ int stg_chunk(int r, int q) { return (q & ~7) | ((q ^ r) & 7); }
__device__ __forceinline__ int stg_word(int r, int col) {
  return r * 64 + stg_chunk(r, col >> 3) * 4 + ((col & 7) >> 1);
}

// relu(lo), relu(hi) rounded to bf16, packed (one cvt.rn.relu.bf16x2.f32).
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}


// One k-step of a chunk, NI instructions of width NW over the box's rows.
template <int NW, int I>
__device__ __forceinline__ void mma_rs(float (&acc)[128], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  const uint64_t d = db + (uint64_t)(I * NW * 8);   // row I * NW of the box, 16-byte units
  if constexpr (NW == 256) wgmma_rs_n256(acc, a, d, accumulate);
  else if constexpr (NW == 64) wgmma_rs_n64<I * 32>(acc, a, d, accumulate);
  else wgmma_rs_n16<I * 8>(acc, a, d, accumulate);
}

template <int NW, int I>
__device__ __forceinline__ void mma_ss(float (&acc)[128], uint64_t da, uint64_t db,
                                       int accumulate) {
  const uint64_t d = db + (uint64_t)(I * NW * 8);
  if constexpr (NW == 256) wgmma_ss_n256(acc, da, d, accumulate);
  else if constexpr (NW == 64) wgmma_ss_n64<I * 32>(acc, da, d, accumulate);
  else wgmma_ss_n16<I * 8>(acc, da, d, accumulate);
}

// The weight ring as a consumer warpgroup walks it.
struct Ring {
  unsigned char* base;
  uint64_t *full, *empty;
  int stage, prev;
  uint32_t ph;
#ifdef DMNERF_FWD_STAMPS
  uint32_t* st;   // this warp's row of stamps in shared memory
#endif
};

__device__ __forceinline__ uint64_t ring_take(Ring& r) {
  DM_TIMED(r.st[ST_FULL], mbar_wait(&r.full[r.stage], r.ph));
  return desc_sw128(r.base + r.stage * F_STAGE_BYTES, 16, 1024);
}

// Give a stage back to the producers of both blocks of the cluster (their boxes land in
// both blocks' rings).
__device__ __forceinline__ void ring_release(Ring& r, int stage, int lane) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(&r.empty[stage]);
    mbar_arrive_cluster(&r.empty[stage], cluster_rank() ^ 1u);
  }
}

// After a chunk's products are issued: commit them, wait for the chunk before, and give
// that one's stage back.
__device__ __forceinline__ void ring_next(Ring& r, int lane) {
  wg_commit();
  DM_TIMED(r.st[ST_PACE], wg_wait<1>());
  if (r.prev >= 0) ring_release(r, r.prev, lane);
  r.prev = r.stage;
  if (++r.stage == F_STAGES) {
    r.stage = 0;
    r.ph ^= 1;
  }
}

// acc = A W for one layer: its chunks in order (ed | e | h in four 64-column chunks |
// e), each 4 k-steps of NI instructions of width NW. A from the embedding tiles (da_e,
// da_ed: this warpgroup's 64 rows) or from the register fragments af. With HALVES (the
// head probes) also h's first or last two chunks alone.
template <int NW, int NI, bool HALVES = false>
__device__ __forceinline__ void layer_product(float (&acc)[128], uint32_t (&af)[16][4],
                                              int segs, uint64_t da_e, uint64_t da_ed, Ring& r,
                                              int lane) {
  int acc_on = 0;
  r.prev = -1;
#define DM_SS_CHUNK(DA)                                                \
  {                                                                    \
    const uint64_t db = ring_take(r);                                  \
    fence_regs(acc);                                                   \
    fence_regs(af);                                                    \
    wg_fence();                                                        \
    _Pragma("unroll") for (int ks = 0; ks < 4; ++ks) {                 \
      const int on = ks > 0 ? 1 : acc_on;                              \
      mma_ss<NW, 0>(acc, (DA) + 2 * ks, db + 2 * ks, on);              \
      if constexpr (NI > 1) mma_ss<NW, 1>(acc, (DA) + 2 * ks, db + 2 * ks, on); \
      if constexpr (NI > 2) mma_ss<NW, 2>(acc, (DA) + 2 * ks, db + 2 * ks, on); \
    }                                                                  \
    ring_next(r, lane);                                                \
    acc_on = 1;                                                        \
  }
#define DM_RS_CHUNK(C)                                                 \
  {                                                                    \
    const uint64_t db = ring_take(r);                                  \
    fence_regs(acc);                                                   \
    fence_regs(af);                                                    \
    wg_fence();                                                        \
    _Pragma("unroll") for (int ks = 0; ks < 4; ++ks) {                 \
      const int on = ks > 0 ? 1 : acc_on;                              \
      mma_rs<NW, 0>(acc, af[4 * (C) + ks], db + 2 * ks, on);           \
      if constexpr (NI > 1) mma_rs<NW, 1>(acc, af[4 * (C) + ks], db + 2 * ks, on); \
      if constexpr (NI > 2) mma_rs<NW, 2>(acc, af[4 * (C) + ks], db + 2 * ks, on); \
    }                                                                  \
    ring_next(r, lane);                                                \
    acc_on = 1;                                                        \
  }
  if (segs & SEG_ED) DM_SS_CHUNK(da_ed)
  if (segs & SEG_E_FIRST) DM_SS_CHUNK(da_e)
  if (segs & SEG_H) {
    DM_RS_CHUNK(0)
    DM_RS_CHUNK(1)
    DM_RS_CHUNK(2)
    DM_RS_CHUNK(3)
  }
  if constexpr (HALVES) {
    if (segs & SEG_H_LO) {
      DM_RS_CHUNK(0)
      DM_RS_CHUNK(1)
    }
    if (segs & SEG_H_HI) {
      DM_RS_CHUNK(2)
      DM_RS_CHUNK(3)
    }
  }
  if (segs & SEG_E_LAST) DM_SS_CHUNK(da_e)
#undef DM_SS_CHUNK
#undef DM_RS_CHUNK
  DM_TIMED(r.st[ST_DRAIN], wg_wait<0>());
  fence_regs(acc);
  fence_regs(af);
  if (r.prev >= 0) ring_release(r, r.prev, lane);
}

// The embedding warps' share of a tile: its embedding tiles e and ed (swizzled, all 64
// columns written, zeros past EP / EDP and past P). ROWS_RAY_Z first forms the tile's
// points in `xs` ([128][3] fp32 in shared memory) as the plain path does, o + (d * z);
// under CMP_MAPS (K8f) the flagship's multires 10 is a constant of the embedding's index
// arithmetic, whose divisions then compile to multiplications (the same values; K8f
// 3.7 % faster on an H100 80GB HBM3 at 700 W, PERF.md §6).
template <Rows ROWS, int CMP = CMP_NONE>
__device__ __forceinline__ void build_tile(__nv_bfloat16* e, __nv_bfloat16* ed,
                                           const void* pt_src, const void* ed_src,
                                           const FwdParams& p, long long p0, int tid,
                                           float* xs) {
  if constexpr (ROWS == ROWS_RAY_Z) {
    bar_sync(1, EMB_THREADS);   // the last tile's embedding has read xs
    for (int c = tid; c < FT * 3; c += EMB_THREADS) {
      const int r = c / 3, ch = c - 3 * r;
      const long long pt = p0 + r;
      float v = 0.f;
      if (pt < p.P) {
        const long long ray = pt / p.S;
        v = __fadd_rn(p.ray_o[ray * 3 + ch], __fmul_rn(p.ray_d[ray * 3 + ch], p.ray_z[pt]));
      }
      xs[c] = v;
    }
    bar_sync(1, EMB_THREADS);
    const long long rows = p.P - p0 < FT ? p.P - p0 : FT;
    if (CMP == CMP_MAPS && p.multires == 10)
      embed_rows<true>(e, xs, 0, rows > 0 ? rows : 0, 10, 64, 64, tid, EMB_THREADS);
    else
      embed_rows<true>(e, xs, 0, rows > 0 ? rows : 0, p.multires, 64, 64, tid, EMB_THREADS);
  } else {
    embed_rows<true>(e, static_cast<const float*>(pt_src), p0, p.P, p.multires, 64, 64, tid,
                     EMB_THREADS);
  }
  if constexpr (ROWS == ROWS_POINT_DIRS) {
    embed_rows<true>(ed, static_cast<const float*>(ed_src), p0, p.P, p.multires_views, 64, 64,
                     tid, EMB_THREADS);
  } else {
    const __nv_bfloat16* table = static_cast<const __nv_bfloat16*>(ed_src);
    const int chunks = p.edp / 8;
    for (int c = tid; c < FT * 8; c += EMB_THREADS) {
      const int r = c >> 3, q = c & 7;
      const long long pt = p0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q < chunks && pt < p.P)
        v = *reinterpret_cast<const uint4*>(table + (pt / p.S) * p.edp + q * 8);
      *reinterpret_cast<uint4*>(ed + sw128(r, q * 8)) = v;
    }
  }
}

// ROWS_H: the ed tile of rows p0 .. p0 + FT from edT [edt_rows, P] bf16, transposed by
// the embedding warps: a thread gathers one 16-byte chunk (8 columns) of a row, the
// threads of a warp on consecutive rows, so each column's reads are contiguous. Zeros
// past edt_rows and past P.
__device__ __forceinline__ void build_edt(__nv_bfloat16* ed, const FwdParams& p, long long p0,
                                          int tid) {
  for (int c = tid; c < FT * 8; c += EMB_THREADS) {
    const int r = c & (FT - 1), q = c >> 7;
    const long long pt = p0 + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (pt < p.P) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = q * 8 + k;
        if (row < p.edt_rows) w[k >> 1] |= (uint32_t)p.edt[row * p.P + pt] << (16 * (k & 1));
      }
    }
    *reinterpret_cast<uint4*>(ed + sw128(r, q * 8)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ROWS_H: a value of a row at an output column: stored into out [P, pitch], or added to
// this lane's part of the row's sum
__device__ __forceinline__ void head_emit(const FwdParams& p, float* out, long long row, int col,
                                          float v, float& rs) {
  if (p.o_kind == OUT_ROWSUM)
    rs += v;
  else if (row < p.P)
    out[row * p.o_pitch + col] = v;
}

// bf16 x 2 (low column first) to two floats
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// The compositing buffers of a block (cmp_smem) and the two mbarriers between the
// consumers, which stage a tile's sigma (`sig`) and output columns (`raw`, [FT][CMP_PITCH])
// and arrive on `full`, and the embedding warps, which composite it and arrive on `empty`.
struct CmpBufs {
  float *xs, *sig, *alpha, *lg, *z, *w, *raw, *carry;
  uint64_t *full, *empty;
};

// The embedding warps (tid of EMB_THREADS) composite the `it`-th tile of the walk, rows
// p0 .. p0 + FT, in row order, once its consumers have staged it. A ray starts at a row
// whose sample index (row mod S) is 0; the scan warp's `carry` is the log-transmittance
// of the ray open at the tile's start, and c.carry its sums (CMP_MAPS). Rows past P take
// part in the sums of rays past N, which are never stored. `wait` sums the cycles of the
// wait for the staged tile (DMNERF_FWD_STAMPS).
template <int CMP>
__device__ __forceinline__ void composite_tile(const FwdParams& p, float* __restrict__ out,
                                               const CmpBufs& c, long long p0, int it, int tid,
                                               float& carry, uint32_t& wait) {
  DM_TIMED(wait, mbar_wait(c.full, it & 1));
#ifdef DMNERF_FWD_NO_COMPOSITE
  // a measurement build: the hand-off without the compositing
  mbar_arrive(c.empty);
  return;
#endif
  const int S = p.S;
  const int s0 = (int)(p0 % S);
  // a row: alpha = 1 - exp(-relu(sigma) dist) with dist = (z' - z, or 1e10 at the ray's
  // last sample) |d|, and log(max(1 - alpha, 1e-10)), in the plain version's order
  for (int r = tid; r < FT; r += EMB_THREADS) {
    const long long pt = p0 + r;
    float a = 0.f, lg = 0.f, zz = 0.f;
    if (pt < p.P) {
      const long long ray = pt / S;
      const float dx = p.ray_d[ray * 3], dy = p.ray_d[ray * 3 + 1], dz = p.ray_d[ray * 3 + 2];
      const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
      zz = p.ray_z[pt];
      const float dist = (pt - ray * S + 1 < S ? p.ray_z[pt + 1] - zz : 1e10f) * dn;
      a = 1.f - expf(-fmaxf(c.sig[r], 0.f) * dist);
      lg = logf(fmaxf(1.f - a, 1e-10f));
    }
    c.alpha[r] = a;
    c.lg[r] = lg;
    c.z[r] = zz;
    if constexpr (CMP == CMP_MAPS) {
      // the sigmoid of the row's rgb here, a row a thread, not in the column sums' loop
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float& v = c.raw[r * CMP_PITCH + k];
        v = 1.f / (1.f + expf(-v));
      }
    }
  }
  if constexpr (CMP == CMP_WEIGHTS) mbar_arrive(c.empty);   // the staged sigma is read
  bar_sync(1, EMB_THREADS);
  if (tid < 32) {
    // the exclusive scan of log(1 - alpha) along each ray, in one warp: lane l takes
    // rows 4 l .. 4 l + 3 (ex: the sum of its rows before each since the last ray start)
    const int lane = tid;
    float ex[4], run = 0.f;
    int head = 0;   // bit k: row 4 lane + k starts a ray
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * lane + k;
      if ((s0 + r) % S == 0) {
        run = 0.f;
        head |= 1 << k;
      }
      ex[k] = run;
      run += c.lg[r];
    }
    // a segmented inclusive scan over the lanes of their open sums: a lane that starts a
    // ray takes nothing from the lanes before it
    float sc = run;
    int f = head != 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float so = __shfl_up_sync(0xffffffffu, sc, off);
      const int fo = __shfl_up_sync(0xffffffffu, f, off);
      if (lane >= off) {
        if (!f) sc = so + sc;
        f |= fo;
      }
    }
    // what the lanes before give this lane's first ray: their open sum, and the tile
    // before's where no ray starts in them
    float pre = __shfl_up_sync(0xffffffffu, sc, 1);
    int pf = __shfl_up_sync(0xffffffffu, f, 1);
    if (lane == 0) {
      pre = 0.f;
      pf = 0;
    }
    if (!pf) pre = carry + pre;
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 4 * lane + k;
      const bool started = (head & ((2 << k) - 1)) != 0;   // a ray starts at or before row r
      w[k] = c.alpha[r] * expf(started ? ex[k] : pre + ex[k]);
      c.w[r] = w[k];
    }
    const float last = __shfl_sync(0xffffffffu, sc, 31);
    carry = __shfl_sync(0xffffffffu, f, 31) ? last : carry + last;
    if constexpr (CMP == CMP_WEIGHTS) {
      // the weights [N, S] are the rows in order
      const long long pt = p0 + 4 * lane;
      if (pt + 3 < p.P) {
        *reinterpret_cast<float4*>(out + pt) = make_float4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (pt + k < p.P) out[pt + k] = w[k];
      }
    }
  }
  if constexpr (CMP == CMP_MAPS) {
    bar_sync(1, EMB_THREADS);
    // one thread a column of [sigmoid(rgb) | z | instance logits] (the rgb sigmoids taken
    // above): the sum of w * value over each ray's rows in row order, stored when the ray
    // ends (the instance columns through a sigmoid); the ray open at the tile's end
    // carries its sum
    if (tid < p.c4) {
      const int col = tid;
      long long ray = p0 / S;
      float acc = s0 == 0 ? 0.f : c.carry[col];
      int s = s0;
#pragma unroll 4
      for (int r = 0; r < FT; ++r) {
        if (s == 0 && r > 0) {
          if (ray * S < p.P) out[ray * p.c4 + col] = col < 4 ? acc : 1.f / (1.f + expf(-acc));
          acc = 0.f;
          ++ray;
        }
        const float v = col == 3 ? c.z[r] : c.raw[r * CMP_PITCH + col];
        acc += c.w[r] * v;
        if (++s == S) s = 0;
      }
      if (s == 0) {
        if (ray * S < p.P) out[ray * p.c4 + col] = col < 4 ? acc : 1.f / (1.f + expf(-acc));
      } else {
        c.carry[col] = acc;
      }
    }
    mbar_arrive(c.empty);   // the staged tile is read
  }
  bar_sync(1, EMB_THREADS);   // the row buffers are free for the next tile
}

// Rows p0 .. of a swizzled [FT][64] tile, columns [0, width), to a row-major [P, width]
// bf16 array; rows past P are not stored.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const __nv_bfloat16* tile,
                                           int width, long long p0, long long P, int tid) {
  const int chunks = width / 8;
  for (int c = tid; c < FT * chunks; c += EMB_THREADS) {
    const int r = c / chunks, q = c - r * chunks;
    if (p0 + r < P)
      *reinterpret_cast<uint4*>(dst + (p0 + r) * width + q * 8) =
          *reinterpret_cast<const uint4*>(tile + sw128(r, q * 8));
  }
}

template <Rows ROWS, bool STASH, int CMP = CMP_NONE, int SCHED = SCHED_LOCKSTEP>
__global__ void __launch_bounds__(F_THREADS, 1)
fused_mlp_fwd_kernel(const __grid_constant__ FwdParams p, const void* __restrict__ pt_src,
                     const void* __restrict__ ed_src, const float* __restrict__ biases,
                     float* __restrict__ out, __nv_bfloat16* __restrict__ stash) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = smem;                                   // [stage][<=256][64] bf16
  unsigned char* emb = smem + F_STAGES * F_STAGE_BYTES;   // [buf][e, ed][128][64]; ROWS_H: x
  unsigned char* hed = emb + 4 * EMB_BYTES;               // ROWS_H: [buf][128][64] ed tiles
  unsigned char* stg = hed + (ROWS == ROWS_H ? 2 * EMB_BYTES : 0);   // STASH: [wg][64][128]
  float* cmp = reinterpret_cast<float*>(stg + (STASH ? 2 * STG_BYTES : 0));   // cmp_smem
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(cmp) +
                                               cmp_smem<CMP>());
  uint64_t* empty = full + F_STAGES;
  uint64_t* emb_full = empty + F_STAGES;
  uint64_t* emb_empty = emb_full + 2;
  uint64_t* x_full = emb_empty + 2;   // ROWS_H: the x tile is loaded, and taken
  uint64_t* x_empty = x_full + 1;
#ifdef DMNERF_FWD_STAMPS
  uint32_t* stamp_row = reinterpret_cast<uint32_t*>(full + fwd_barriers<CMP, ROWS>()) +
                        (threadIdx.x >> 5) * N_STAMPS;
  for (int i = threadIdx.x & 31; i < N_STAMPS; i += 32) stamp_row[i] = 0u;
#endif
  CmpBufs cb{};
  if constexpr (CMP != CMP_NONE) {
    cb.xs = cmp;
    cb.sig = cb.xs + FT * 3;
    cb.alpha = cb.sig + FT;
    cb.lg = cb.alpha + FT;
    cb.z = cb.lg + FT;
    cb.w = cb.z + FT;
    cb.raw = cb.w + FT;
    cb.carry = cb.raw + FT * CMP_PITCH;
    cb.full = emb_empty + 2;
    cb.empty = cb.full + 1;
  }

  // a cluster of two blocks shares the weight stream: of each pair q of spans (`span`
  // tiles each; one tile without CMP) block `rank` takes span 2 q + rank and walks its
  // tiles in order; the pair's blocks walk the same pairs, the second on tiles past P
  // (zeros, nothing stored) where the span count is odd
  const uint32_t rank = cluster_rank();
  const int pair0 = (int)cluster_index(), pairs = (int)cluster_count();
  const int span = CMP != CMP_NONE ? p.span : 1;
  const int n_spans = CMP != CMP_NONE ? p.n_spans : p.n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * F_CONSUMERS / 32);   // both blocks' consumer warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&emb_full[b], ROWS == ROWS_EMBEDDED ? 1 : EMB_THREADS);
      mbar_init(&emb_empty[b], F_CONSUMERS / 32);
    }
    if constexpr (CMP != CMP_NONE) {
      mbar_init(cb.full, F_CONSUMERS);
      mbar_init(cb.empty, EMB_THREADS);
    }
    if constexpr (ROWS == ROWS_H) {
      mbar_init(x_full, 1);
      mbar_init(x_empty, F_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  cluster_sync();   // both blocks' barriers exist before any box or remote arrival

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x >= F_CONSUMERS) {
    regs_dec<40>();
    if (warp == F_CONSUMERS / 32) {
      // ---- producer: every chunk of every tile, in order ----
      if (lane == 0) {
        int stage = 0;
        uint32_t ph = 0;
        for (int q = pair0; 2 * q < n_spans; q += pairs) {
          for (int jt = 0; jt < span; ++jt) {
            for (int c = 0; c < p.n_chunks; ++c) {
              const FChunk ch = p.chunks[c];
              mbar_wait(&empty[stage], ph ^ 1);
              mbar_expect_tx(&full[stage], (uint32_t)ch.half * 256u);
              tma_load_2d_multicast(ring + stage * F_STAGE_BYTES + rank * ch.half * 128,
                                    &p.maps[ch.map], &full[stage], ch.k0, (int)rank * ch.half,
                                    (uint16_t)3);
              if (++stage == F_STAGES) {
                stage = 0;
                ph ^= 1;
              }
            }
          }
        }
      }
    } else {
      // ---- embedding warps: each tile's embeddings, one tile ahead of the consumers;
      // under CMP then the compositing of the tile before ----
      const int tid = threadIdx.x - F_CONSUMERS - 32;
      int it = 0;
      long long prev_p0 = 0;
      float carry = 0.f;   // CMP: the scan warp's log-transmittance of the open ray
      uint32_t cmp_wait = 0;
#ifdef DMNERF_FWD_STAMPS
      uint32_t* es = stamp_row;
      const uint32_t t_walk = stamp_clock();
#endif
      for (int q = pair0; 2 * q < n_spans; q += pairs) {
        for (int jt = 0; jt < span; ++jt, ++it) {
          const int b = it & 1;
          const long long p0 = ((long long)(2 * q + rank) * span + jt) * FT;
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(emb + 2 * b * EMB_BYTES);
          __nv_bfloat16* ed = e + EMB_BYTES / 2;
          if constexpr (ROWS == ROWS_EMBEDDED) {
            if (tid == 0) {
              mbar_wait(&emb_empty[b], ((it >> 1) & 1) ^ 1);
              mbar_expect_tx(&emb_full[b], 2 * EMB_BYTES);
              tma_load_2d(e, &p.e_map, &emb_full[b], 0, (int)p0);
              tma_load_2d(ed, &p.ed_map, &emb_full[b], 0, (int)p0);
            }
          } else if constexpr (ROWS == ROWS_H) {
            // x's tile once the consumers have taken the last one; edT's into ed tile b
            if (tid == 0) {
              DM_TIMED(es[ST_E_WAIT], mbar_wait(x_empty, (it & 1) ^ 1));
              mbar_expect_tx(x_full, 4 * EMB_BYTES);
              for (int c = 0; c < 4; ++c)
                tma_load_2d(emb + c * EMB_BYTES, &p.e_map, x_full, 64 * c, (int)p0);
            }
            DM_TIMED(es[ST_E_WAIT], mbar_wait(&emb_empty[b], ((it >> 1) & 1) ^ 1));
            DM_STAMP_START(t_build);
#ifndef DMNERF_FWD_NO_BUILD
            if (p.edt != nullptr)
              build_edt(reinterpret_cast<__nv_bfloat16*>(hed + b * EMB_BYTES), p, p0, tid);
#endif
            fence_proxy_async();
            mbar_arrive(&emb_full[b]);
            DM_STAMP_ADD(es[ST_E_BUILD], t_build);
          } else {
            DM_TIMED(es[ST_E_WAIT], mbar_wait(&emb_empty[b], ((it >> 1) & 1) ^ 1));
            DM_STAMP_START(t_build);
#ifndef DMNERF_FWD_NO_BUILD
            build_tile<ROWS, CMP>(e, ed, pt_src, ed_src, p, p0, tid, cb.xs);
#endif
            if constexpr (STASH) {
              bar_sync(1, EMB_THREADS);
              if (p.e_stash >= 0) store_tile(stash + p.e_stash, e, p.ep, p0, p.P, tid);
              if (p.ed_stash >= 0) store_tile(stash + p.ed_stash, ed, p.edp, p0, p.P, tid);
            }
            fence_proxy_async();
            mbar_arrive(&emb_full[b]);
            DM_STAMP_ADD(es[ST_E_BUILD], t_build);
          }
          if constexpr (CMP != CMP_NONE) {
            if (it > 0)
              DM_TIMED(es[ST_E_CMP],
                       composite_tile<CMP>(p, out, cb, prev_p0, it - 1, tid, carry, cmp_wait));
            prev_p0 = p0;
          }
        }
      }
      if constexpr (CMP != CMP_NONE) {
        if (it > 0)
          DM_TIMED(es[ST_E_CMP],
                   composite_tile<CMP>(p, out, cb, prev_p0, it - 1, tid, carry, cmp_wait));
      }
#ifdef DMNERF_FWD_STAMPS
      const uint32_t walk = stamp_clock() - t_walk;
      __syncwarp();
      if (lane == 0) {
        es[ST_E_WALK] = walk;
        es[ST_E_CMPWAIT] = cmp_wait;
        es[ST_E_TILES] = (uint32_t)it;
      }
      stamps_flush(es, ST_E_WALK, ST_E_TILES - ST_E_WALK + 1, ST_E_WARPS, lane);
#endif
    }
  } else {
    // ---- consumers: warpgroup wg owns points [64 wg, 64 wg + 64) of each tile ----
    regs_inc<232>();
    const int wg = threadIdx.x >> 7;
    const int g = lane >> 2, t = lane & 3;
    const long long P = p.P;
    Ring r{ring, full, empty, 0, -1, 0u};
    float acc[128];
    uint32_t af[16][4];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) af[i][v] = 0u;
    float sg0 = 0.f, sg1 = 0.f;   // sigma of rows r0, r1 (lanes t == 0)
#ifdef DMNERF_FWD_NO_EPILOGUE
    float keep = 0.f;
#endif
#ifdef DMNERF_FWD_STAMPS
    r.st = stamp_row;
    const uint32_t t_walk = stamp_clock();
#endif
    int it = 0;
    for (int q = pair0; 2 * q < n_spans; q += pairs)
    for (int jt = 0; jt < span; ++jt, ++it) {
      const int b = it & 1;
      const long long p0 = ((long long)(2 * q + rank) * span + jt) * FT;
      const int lr0 = (warp & 3) * 16 + g;   // the warp's first row in the warpgroup's 64
      const long long r0 = p0 + wg * 64 + lr0, r1 = r0 + 8;
      unsigned char* e_tile = emb + 2 * b * EMB_BYTES + wg * (EMB_BYTES / 2);
      unsigned char* ed_tile =
          ROWS == ROWS_H ? hed + b * EMB_BYTES + wg * (EMB_BYTES / 2) : e_tile + EMB_BYTES;
      const uint64_t da_e = desc_sw128(e_tile, 16, 1024);
      const uint64_t da_ed = desc_sw128(ed_tile, 16, 1024);
      DM_TIMED(r.st[ST_HANDOFF], mbar_wait(&emb_full[b], (it >> 1) & 1));
      float rs0 = 0.f, rs1 = 0.f;   // ROWS_H: the row sums of rows r0, r1 (this lane's part)
      if constexpr (ROWS == ROWS_H) {
        // this warpgroup's 64 rows of x into the A fragments (the m64nNk16 layout: rows
        // lr0, lr0 + 8, columns 16 ks + 2 t and + 8), then the tile goes back to the loader
        DM_TIMED(r.st[ST_HANDOFF], mbar_wait(x_full, it & 1));
        const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(emb + wg * (EMB_BYTES / 2));
#pragma unroll
        for (int ks = 0; ks < 16; ++ks) {
          const __nv_bfloat16* blk = xt + (ks >> 2) * (EMB_BYTES / 2);
          const int c0 = (ks & 3) * 16 + 2 * t;
          af[ks][0] = *reinterpret_cast<const uint32_t*>(blk + sw128(lr0, c0));
          af[ks][1] = *reinterpret_cast<const uint32_t*>(blk + sw128(lr0 + 8, c0));
          af[ks][2] = *reinterpret_cast<const uint32_t*>(blk + sw128(lr0, c0 + 8));
          af[ks][3] = *reinterpret_cast<const uint32_t*>(blk + sw128(lr0 + 8, c0 + 8));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(x_empty);
      }

      for (int l = 0; l < p.n_layers; ++l) {
        const FLayer L = p.layers[l];
#define DM_LAYER(NW, NI) \
  layer_product<NW, NI, ROWS == ROWS_H>(acc, af, L.segs, da_e, da_ed, r, lane)
        if constexpr (SCHED == SCHED_PIPELINED) {
          // the wider instruction reads stage rows past the layer's box into columns at
          // or past L.N, which no epilogue reads
          if (L.cls == CLS_16 || L.cls == CLS_64x1) DM_LAYER(64, 1);
          else DM_LAYER(256, 1);
        } else {
          switch (L.cls) {
            case CLS_256: DM_LAYER(256, 1); break;
            case CLS_16: DM_LAYER(16, 1); break;
            case CLS_64x1: DM_LAYER(64, 1); break;
            case CLS_64x2: DM_LAYER(64, 2); break;
            default: DM_LAYER(64, 3); break;
          }
        }
#undef DM_LAYER
#ifdef DMNERF_FWD_STAMPS
        const uint32_t t_epi = stamp_clock(), handoff0 = r.st[ST_HANDOFF];
#endif
#ifdef DMNERF_FWD_NO_EPILOGUE
        // keep every layer's products live: the compiler may drop products whose sums
        // are never read, and each layer's first k-step overwrites the sums
        keep += acc[0];
        if constexpr (CMP != CMP_NONE) {
          // the compositing hand-offs stay (the staged values are not written)
          if (L.epi == EPI_SIGMA) mbar_wait(cb.empty, (it & 1) ^ 1);
          if (L.epi == (CMP == CMP_WEIGHTS ? EPI_SIGMA : EPI_OUT)) mbar_arrive(cb.full);
        }
#else
        const float* bias = biases + L.b_off;
        const bool stashed = STASH && L.epi == EPI_RELU && L.stash_off >= 0;
        if (L.epi == EPI_RELU && L.N == 256 && !stashed) {
          // the full-width layers without a stash: no column guard, so the bias loads and
          // conversions of all 32 column groups can overlap
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + j * 8 + 2 * t));
            af[j >> 1][(j & 1) * 2] = relu_bf16x2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
            af[j >> 1][(j & 1) * 2 + 1] =
                relu_bf16x2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
          }
        } else if (L.epi == EPI_RELU) {
          // bias, ReLU, bf16: the next product's A fragments, and under STASH the stash's
          // rows, in two halves of 128 columns through the staging tile
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (stashed) bar_sync(2 + wg, FWG);   // the last copy-out of the tile is done
#pragma unroll
            for (int jj = 0; jj < 16; ++jj) {
              const int j = hh * 16 + jj, col = j * 8 + 2 * t;
              uint32_t h0 = 0u, h1 = 0u;
              if (col < L.N) {
                const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
                h0 = relu_bf16x2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
                h1 = relu_bf16x2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
                if constexpr (STASH) {
                  if (stashed) {
                    uint32_t* st = reinterpret_cast<uint32_t*>(stg + wg * STG_BYTES);
                    st[stg_word(lr0, col - hh * 128)] = h0;
                    st[stg_word(lr0 + 8, col - hh * 128)] = h1;
                  }
                }
              }
              af[j >> 1][(j & 1) * 2] = h0;
              af[j >> 1][(j & 1) * 2 + 1] = h1;
            }
            if constexpr (STASH) {
              if (stashed && L.N > hh * 128) {
                // the warpgroup's 64 rows of these columns: 16-byte loads from the staging
                // tile, 16-byte streaming stores, two 256-byte row halves a warp
                // instruction
                bar_sync(2 + wg, FWG);
                const unsigned char* st = stg + wg * STG_BYTES;
                const long long row0 = p0 + wg * 64;
                const int nq = min(L.N - hh * 128, 128) / 8;
                __nv_bfloat16* dst = stash + L.stash_off + row0 * L.N + hh * 128;
                for (int c = threadIdx.x & (FWG - 1); c < 64 * nq; c += FWG) {
                  const int rr = c / nq, q = c - rr * nq;
                  if (row0 + rr < P)
                    __stcs(reinterpret_cast<uint4*>(dst + rr * L.N + q * 8),
                           *reinterpret_cast<const uint4*>(st + rr * 256 + stg_chunk(rr, q) * 16));
                }
              }
            }
          }
        } else if (L.epi == EPI_SIGMA) {
          const float b0 = __ldg(bias);
          sg0 = acc[0] + b0;
          sg1 = acc[2] + b0;
          if constexpr (CMP != CMP_NONE) {
            // stage sigma once the embedding warps have composited the tile before
            DM_TIMED(r.st[ST_HANDOFF], mbar_wait(cb.empty, (it & 1) ^ 1));
            if (t == 0) {
              cb.sig[wg * 64 + lr0] = sg0;
              cb.sig[wg * 64 + lr0 + 8] = sg1;
            }
            if constexpr (CMP == CMP_WEIGHTS) mbar_arrive(cb.full);
          }
          if constexpr (ROWS == ROWS_H) {
            // every lane of the quad holds its rows' sigma; written when the table asks
            sg0 = __shfl_sync(0xffffffffu, sg0, lane & ~3);
            sg1 = __shfl_sync(0xffffffffu, sg1, lane & ~3);
            const FHeadOut ho = p.hout[l];
            if (ho.o_n && t == 0) {
              head_emit(p, out, r0, ho.o_col, sg0, rs0);
              head_emit(p, out, r1, ho.o_col, sg1, rs1);
            }
          }
        } else if (ROWS == ROWS_H && L.epi == EPI_DOT) {
          // sigma = h . w on the CUDA cores: this lane's 64 columns of each of its two rows
          // (the A fragments) against the weight row, then the quad's four parts
          const float* wrow = biases + L.b_off;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int ks = 0; ks < 16; ++ks) {
            const int c0 = ks * 16 + 2 * t;
            const float2 w0 = __ldg(reinterpret_cast<const float2*>(wrow + c0));
            const float2 w8 = __ldg(reinterpret_cast<const float2*>(wrow + c0 + 8));
            s0 = fmaf(bf16_lo(af[ks][0]), w0.x, s0);
            s0 = fmaf(bf16_hi(af[ks][0]), w0.y, s0);
            s0 = fmaf(bf16_lo(af[ks][2]), w8.x, s0);
            s0 = fmaf(bf16_hi(af[ks][2]), w8.y, s0);
            s1 = fmaf(bf16_lo(af[ks][1]), w0.x, s1);
            s1 = fmaf(bf16_hi(af[ks][1]), w0.y, s1);
            s1 = fmaf(bf16_lo(af[ks][3]), w8.x, s1);
            s1 = fmaf(bf16_hi(af[ks][3]), w8.y, s1);
          }
          s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
          s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          sg0 = s0;
          sg1 = s1;
          const FHeadOut ho = p.hout[l];
          if (ho.o_n && t == 0) {
            head_emit(p, out, r0, ho.o_col, sg0, rs0);
            head_emit(p, out, r1, ho.o_col, sg1, rs1);
          }
        } else if (ROWS == ROWS_H) {
          // EPI_COLS: the layer's first o_n columns (+ bias; sig_col takes sigma) to the
          // output window, or into this lane's part of the row sums; h stays as it is
          const FHeadOut ho = p.hout[l];
          const bool pairs = p.o_kind == OUT_COLS && ((p.o_pitch | ho.o_col) & 1) == 0;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = j * 8 + 2 * t;
            if (col < ho.o_n) {
              const bool two = col + 1 < ho.o_n;
              const float b0 = __ldg(bias + col), b1 = two ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const float sg = half ? sg1 : sg0;
                const float v0 = col == ho.sig_col ? sg : acc[4 * j + 2 * half] + b0;
                const float v1 = col + 1 == ho.sig_col ? sg : acc[4 * j + 2 * half + 1] + b1;
                const long long row = half ? r1 : r0;
                if (p.o_kind == OUT_ROWSUM) {
                  float& rs = half ? rs1 : rs0;
                  rs += v0;
                  if (two) rs += v1;
                } else if (row < P) {
                  float* o = out + row * p.o_pitch + ho.o_col + col;
                  if (two && pairs) {
                    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                  } else {
                    o[0] = v0;
                    if (two) o[1] = v1;
                  }
                }
              }
            }
          }
        } else if (CMP == CMP_MAPS) {
          // stage the output columns (sigma's column is not read)
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = j * 8 + 2 * t;
            if (col < p.c4) {
              const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                float* o = cb.raw + (wg * 64 + lr0 + 8 * half) * CMP_PITCH;
                o[col] = acc[4 * j + 2 * half] + b0;
                if (col + 1 < p.c4) o[col + 1] = acc[4 * j + 2 * half + 1] + b1;
              }
            }
          }
          mbar_arrive(cb.full);
        } else {
          // raw = [rgb | sigma | instance logits]: sigma from lane t == 0 into column 3
          const float s0 = __shfl_sync(0xffffffffu, sg0, lane & ~3);
          const float s1 = __shfl_sync(0xffffffffu, sg1, lane & ~3);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = j * 8 + 2 * t;
            if (col < p.c4) {
              const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const long long row = half ? r1 : r0;
                if (row < P) {
                  float* o = out + row * p.c4;
                  o[col] = col == 3 ? (half ? s1 : s0) : acc[4 * j + 2 * half] + b0;
                  if (col + 1 < p.c4)
                    o[col + 1] = col + 1 == 3 ? (half ? s1 : s0) : acc[4 * j + 2 * half + 1] + b1;
                }
              }
            }
          }
        }
#endif
#ifdef DMNERF_FWD_STAMPS
        r.st[ST_EPI] += (stamp_clock() - t_epi) - (r.st[ST_HANDOFF] - handoff0);
#endif
      }
#ifdef DMNERF_FWD_NO_EPILOGUE
      if (p0 < 0) out[0] = keep;
#else
      if constexpr (ROWS == ROWS_H) {
        if (p.o_kind == OUT_ROWSUM) {
          // the quad's four parts of each row sum, in a fixed order
          rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
          rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
          rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
          rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
          if (t == 0) {
            if (r0 < P) out[r0] = rs0;
            if (r1 < P) out[r1] = rs1;
          }
        }
      }
#endif
      // every product that read this tile's embeddings has completed
      __syncwarp();
      if (lane == 0) mbar_arrive(&emb_empty[b]);
    }
#ifdef DMNERF_FWD_STAMPS
    const uint32_t walk = stamp_clock() - t_walk;
    __syncwarp();
    if (lane == 0) {
      r.st[ST_WALK] = walk;
      r.st[ST_TILES] = (uint32_t)it;
    }
    stamps_flush(r.st, ST_WALK, ST_TILES + 1, ST_WARPS, lane);
#endif
  }
  // neither block leaves while the other may still send it boxes or arrivals
  cluster_sync();
}

// The instruction class of a layer of N output columns and the rows its box covers.
inline int layer_class(int N, int* box_rows) {
  static const int cover[N_CLS] = {256, 16, 64, 128, 192};
  const int cls = N <= 16 ? CLS_16 : N <= 192 ? CLS_16 + (N + 63) / 64 : CLS_256;
  *box_rows = cover[cls];
  return cls;
}

// The weight boxes of a plan's maps: encode each of the n_maps rows (off, cols, rows = N,
// pitch) at `row` over the transposed weights `w` into fp.maps, its box rows into `box`.
inline int encode_weight_maps(FwdParams& fp, const __nv_bfloat16* w, const long long* row,
                              int n_maps, int* box) {
  int err;
  for (int i = 0; i < n_maps; ++i, row += 4) {
    layer_class((int)row[2], &box[i]);
    if (row[2] > 256 || (err = encode_map(&fp.maps[i], w + row[0], row[1], row[2], row[3], 64,
                                          box[i] / 2)))
      return row[2] > 256 ? (int)cudaErrorInvalidValue : err;
  }
  return 0;
}

// Launch a kernel of the template on `stream`: clusters of two blocks, as many as the card
// holds at once, at most one a span pair.
template <typename Kernel>
int run_fwd(Kernel kernel, size_t smem, const FwdParams& fp, int n_sms, void* stream,
            const void* pt_src, const void* ed_src, const float* biases, float* out,
            void* stash) {
  const int n_pairs = (fp.n_spans + 1) / 2;
  cudaError_t ee = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (ee != cudaSuccess) return (int)ee;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(2 * (n_sms / 2)), 1, 1);
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((ee = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess)
    return (int)ee;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(2 * (clusters < n_pairs ? clusters : n_pairs)), 1, 1);
  ee = cudaLaunchKernelEx(&cfg, kernel, fp, pt_src, ed_src, biases, out,
                          reinterpret_cast<__nv_bfloat16*>(stash));
  if (ee != cudaSuccess) return (int)ee;
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns 0 when the launch was accepted, a cudaError, or 10000 + a
// CUresult of the tensor-map encoder. `wt` is pack_params's transposed bf16 weights;
// `plan` the int64 table of fused_mlp.py's _fwd_plan:
//   header   n_layers, n_maps, n_chunks, c4, ep, edp, multires, multires_views
//   n_maps   rows off, cols, rows, pitch       (a segment of a transposed block:
//                                              [rows = N][cols] at wt + off, row pitch)
//   n_layers rows segs, N, b_off, epilogue
//   n_chunks rows map, k0                      (the boxes of one tile, in order)
// With a stash (the training forward), `stash_table` is _bwd_plan's (e_off, ed_off,
// then one offset per layer); without one, the render path's kernel runs.
// Under CMP (ROWS_RAY_Z) `rays` is (o, d, z) and `span` the tiles of a span
// (fused_render.py's _render_plan); `out` takes the weights [P] (CMP_WEIGHTS, the table
// ending at sigma) or the maps [P / S, c4] (CMP_MAPS). SCHED is the consumers' schedule.
template <Rows ROWS, int CMP = CMP_NONE, int SCHED = FWD_DEFAULT_SCHED>
int launch_fused_mlp_fwd(const void* pt_src, const void* ed_src, const void* wt,
                         const float* biases, float* out, long long P, int S,
                         const long long* plan, void* stash, const long long* stash_table,
                         int n_sms, void* stream, const float* const* rays = nullptr,
                         int span = 1) {
  const long long* h = plan;
  const int n_layers = (int)h[0], n_maps = (int)h[1], n_chunks = (int)h[2];
  if (n_layers < 0 || n_layers > MAX_LAYERS || n_maps < 0 || n_maps > MAX_FMAPS ||
      n_chunks < 0 || n_chunks > MAX_FCHUNKS || P <= 0 || S <= 0 || n_sms <= 0 ||
      h[4] > 64 || h[5] > 64 || h[4] % 8 || h[5] % 8 || P > (1ll << 31) - FT)
    return (int)cudaErrorInvalidValue;
  if (CMP != CMP_NONE &&
      (rays == nullptr || stash != nullptr || span <= 0 || (span * FT) % S || P % S ||
       n_layers < 1 || (CMP == CMP_MAPS && (h[3] > CMP_PITCH || h[3] < 4))))
    return (int)cudaErrorInvalidValue;
  cudaPointerAttributes attr;
  cudaError_t e;
  if ((e = cudaPointerGetAttributes(&attr, wt)) != cudaSuccess ||
      (e = cudaSetDevice(attr.device)) != cudaSuccess)
    return (int)e;
  static FwdParams fp;
  fp.P = P;
  fp.S = S;
  fp.n_layers = n_layers;
  fp.n_chunks = n_chunks;
  fp.n_tiles = (int)((P + FT - 1) / FT);
  fp.c4 = (int)h[3];
  fp.ep = (int)h[4];
  fp.edp = (int)h[5];
  fp.multires = (int)h[6];
  fp.multires_views = (int)h[7];
  const long long* row = plan + 8;
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(wt);
  int box[MAX_FMAPS], err;
  if ((err = encode_weight_maps(fp, w, row, n_maps, box))) return err;
  row += 4 * n_maps;
  for (int l = 0; l < n_layers; ++l, row += 4) {
    int rows;
    const int N = (int)row[1];
    // the output epilogue reads the sums of columns [0, c4): all of them the layer's
    if (N <= 0 || N > 256 || row[0] <= 0 || row[0] > 15 || row[3] < 0 || row[3] > EPI_OUT ||
        (row[3] == EPI_OUT && h[3] > N))
      return (int)cudaErrorInvalidValue;
    fp.layers[l] = FLayer{(int)row[0], layer_class(N, &rows), N, (int)row[2], (int)row[3],
                          stash == nullptr ? -1 : stash_table[2 + l]};
  }
  for (int c = 0; c < n_chunks; ++c, row += 2) {
    if (row[0] < 0 || row[0] >= n_maps) return (int)cudaErrorInvalidValue;
    fp.chunks[c] = FChunk{(int)row[0], (int)row[1], box[row[0]] / 2};
  }
  fp.e_stash = stash == nullptr ? -1 : stash_table[0];
  fp.ed_stash = stash == nullptr ? -1 : stash_table[1];
  // the walk: spans of `span` tiles; without CMP a span is a tile
  fp.span = CMP != CMP_NONE ? span : 1;
  fp.n_spans = (fp.n_tiles + fp.span - 1) / fp.span;
  fp.ray_o = CMP != CMP_NONE ? rays[0] : nullptr;
  fp.ray_d = CMP != CMP_NONE ? rays[1] : nullptr;
  fp.ray_z = CMP != CMP_NONE ? rays[2] : nullptr;
  // the table of a compositing pass ends where it composites: sigma, or the output
  if (CMP != CMP_NONE &&
      fp.layers[n_layers - 1].epi != (CMP == CMP_WEIGHTS ? EPI_SIGMA : EPI_OUT))
    return (int)cudaErrorInvalidValue;

  if (ROWS == ROWS_EMBEDDED) {
    if ((err = encode_map(&fp.e_map, pt_src, fp.ep, P, fp.ep, 64, FT)) ||
        (err = encode_map(&fp.ed_map, ed_src, fp.edp, P, fp.edp, 64, FT)))
      return err;
  }
  auto run = [&](auto kernel, size_t smem) {
    return run_fwd(kernel, smem, fp, n_sms, stream, pt_src, ed_src, biases, out, stash);
  };
  if constexpr (CMP != CMP_NONE) {
    return run(fused_mlp_fwd_kernel<ROWS, false, CMP, SCHED>, fwd_smem<false, CMP, ROWS>());
  } else {
    if (stash == nullptr)
      return run(fused_mlp_fwd_kernel<ROWS, false, CMP_NONE, SCHED>,
                 fwd_smem<false, CMP_NONE, ROWS>());
    return run(fused_mlp_fwd_kernel<ROWS, true, CMP_NONE, SCHED>,
               fwd_smem<true, CMP_NONE, ROWS>());
  }
}

// Launch a head probe (ROWS_H: head512.cu K9, heads_fused.cu K10) on `stream`; returns as
// launch_fused_mlp_fwd. `x` is [P, 256] bf16 (16-byte aligned), `edt` [edt_rows, P] bf16 or
// null, `wt` and `biases` head_probes.py's ProbeOperands, `plan` the int64 table of its
// _probe_plan:
//   header   n_layers, n_maps, n_chunks, out kind (HeadOut), out pitch, EDP, 0, 0
//   n_maps   rows off, cols, rows, pitch      (as launch_fused_mlp_fwd's)
//   n_layers rows segs, N, b_off, epilogue, o_col, o_n, sig_col
//   n_chunks rows map, k0
// `out` takes [P, pitch] (OUT_COLS) or the row sums [P] (OUT_ROWSUM); SCHED is the
// consumers' schedule. A template, so that only the sources that call it (head512.cu,
// heads_fused.cu) compile its kernel.
template <int SCHED = FWD_DEFAULT_SCHED, Rows ROWS = ROWS_H>
int launch_head_probe(const void* x, const void* edt, int edt_rows, const void* wt,
                      const float* biases, float* out, long long P, const long long* plan,
                      int n_sms, void* stream) {
  static_assert(ROWS == ROWS_H, "the head probes walk ROWS_H");
  const long long* h = plan;
  const int n_layers = (int)h[0], n_maps = (int)h[1], n_chunks = (int)h[2];
  const int o_kind = (int)h[3], o_pitch = (int)h[4], edp = (int)h[5];
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_maps < 0 || n_maps > MAX_FMAPS ||
      n_chunks < 0 || n_chunks > MAX_FCHUNKS || P <= 0 || n_sms <= 0 || P > (1ll << 31) - FT ||
      (o_kind != OUT_COLS && o_kind != OUT_ROWSUM) || o_pitch < 1 || edp < 0 || edp > 64 ||
      edp % 8 || edt_rows < 0 || edt_rows > edp || (edt == nullptr) != (edt_rows == 0))
    return (int)cudaErrorInvalidValue;
  cudaPointerAttributes attr;
  cudaError_t e;
  if ((e = cudaPointerGetAttributes(&attr, wt)) != cudaSuccess ||
      (e = cudaSetDevice(attr.device)) != cudaSuccess)
    return (int)e;
  static FwdParams fp;
  fp = FwdParams{};
  fp.P = P;
  fp.S = 1;
  fp.n_layers = n_layers;
  fp.n_chunks = n_chunks;
  fp.n_tiles = (int)((P + FT - 1) / FT);
  fp.edp = edp;
  fp.e_stash = fp.ed_stash = -1;
  fp.span = 1;
  fp.n_spans = fp.n_tiles;
  fp.edt = static_cast<const unsigned short*>(edt);
  fp.edt_rows = edt_rows;
  fp.o_kind = o_kind;
  fp.o_pitch = o_pitch;
  int box[MAX_FMAPS], err;
  if ((err = encode_weight_maps(fp, reinterpret_cast<const __nv_bfloat16*>(wt), plan + 8, n_maps,
                                box)))
    return err;
  const long long* row = plan + 8 + 4 * n_maps;
  const int segs_all = SEG_ED | SEG_H | SEG_H_LO | SEG_H_HI;
  for (int l = 0; l < n_layers; ++l, row += 7) {
    int rows;
    const int segs = (int)row[0], N = (int)row[1], epi = (int)row[3];
    const int o_col = (int)row[4], o_n = (int)row[5], sig = (int)row[6];
    const bool sigma = epi == EPI_SIGMA || epi == EPI_DOT;
    if ((segs & ~segs_all) || (epi != EPI_RELU && epi != EPI_COLS && !sigma) ||
        ((epi == EPI_DOT) != (segs == 0)) || (epi != EPI_DOT && (N <= 0 || N > 256)) ||
        ((segs & SEG_ED) && edp == 0) || row[2] < 0 || o_n < 0 ||
        (epi == EPI_RELU && o_n != 0) || (sigma && o_n > 1) || (epi == EPI_COLS && o_n > N) ||
        (o_kind == OUT_COLS && o_n > 0 && (o_col < 0 || o_col + o_n > o_pitch)) ||
        (sig != -1 && (epi != EPI_COLS || sig < 0 || sig >= o_n)))
      return (int)cudaErrorInvalidValue;
    fp.layers[l] = FLayer{segs, layer_class(N, &rows), N, (int)row[2], epi, -1};
    fp.hout[l] = FHeadOut{o_col, o_n, sig};
  }
  for (int c = 0; c < n_chunks; ++c, row += 2) {
    if (row[0] < 0 || row[0] >= n_maps) return (int)cudaErrorInvalidValue;
    fp.chunks[c] = FChunk{(int)row[0], (int)row[1], box[row[0]] / 2};
  }
  if ((err = encode_map(&fp.e_map, x, 256, P, 256, 64, FT))) return err;
  return run_fwd(fused_mlp_fwd_kernel<ROWS, false, CMP_NONE, SCHED>,
                 fwd_smem<false, CMP_NONE, ROWS>(), fp, n_sms, stream, x, edt, biases, out,
                 nullptr);
}

// A launch under a schedule given at run time, one of the compiled schedules S...:
// `launch` is called with it as a compile-time constant; any other value is refused.
template <int... S, typename Launch>
int with_schedule(int schedule, Launch launch) {
  int err = (int)cudaErrorInvalidValue;
  (void)((schedule == S ? (err = launch(std::integral_constant<int, S>{}), true) : false) || ...);
  return err;
}

}  // namespace

#ifdef DMNERF_FWD_STAMPS
// The stamps of the launches since the last reset (DMNERF_FWD_STAMPS builds): copies the
// N_STAMPS sums into `host` when it is not null, then zeroes them when `reset` is set.
extern "C" int dmnerf_fwd_stamps(unsigned long long* host, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && host != nullptr)
    e = cudaMemcpyFromSymbol(host, g_fwd_stamps, sizeof(g_fwd_stamps));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[N_STAMPS] = {};
    e = cudaMemcpyToSymbol(g_fwd_stamps, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif
