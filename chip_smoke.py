"""Drive the PyTorch/H100 port (dmnerf_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

0. Requires a CUDA card of capability 9.0 and prints its name and power limit.
   TF32 is off, so the fp32 plain path is really fp32.
1. Builds every kernel of the render, train and manipulation paths and the probes (K1-K11) from
   dmnerf_tpu_torch/kernels/csrc with nvcc (sm_90a), one process per source, all
   started together, and prints the build time and the compiler's register report.
2. Kernel phase, at the flagship model's width (configs/test/dmsr/study.txt:
   D=8, W=256, skips (4,), multires 10/4, ins_num 32) with seeded random weights
   and points along rays between near and far, once for K1 (pe_mode 'kernel_t',
   per-ray viewdirs) and once for K3 (pe_mode 'kernel', per-point directions): the
   fused PE+MLP kernel on a fine chunk (2048 x 192 points, full model) and a coarse
   chunk (2048 x 64, sigma stub), and for K3 also a fine chunk through the rgb stub
   (the manipulation's label queries), held against its plain version in fp32
   (max|d| <= 5e-3 * max(scale, 1)) and in bf16 (printed); the stubs' sigma column
   against the full model's, both from the kernel (within 1e-5 * max(sigma scale,
   1)). Median times of the kernel, the fp32 plain version and a bf16 torch.addmm
   chain over the same packed layers (the library yardstick, used nowhere in the
   port), beside the bound: executed matrix FLOPs over the card's 989 TFLOP/s bf16
   peak, or bytes over 3.35 TB/s, whichever is larger.
3. Slice phase: a synthetic DM-SR scene built in memory (256x256, 2 test views,
   4 objects, ins_num 32, near 1, far 8) rendered by the port's render_test with
   seeded full-width weights. Every map must be finite and in range, the kernel's
   launch count must be 2 x chunks x views, and one view rendered with the plain
   PyTorch query on the card must agree with the kernel's render (rgb PSNR >= 40 dB,
   at most 1% of pixels with another argmax instance label).
4. Backward kernel phase, at the flagship width and the training shapes
   (configs/train/dmsr/study.txt: N_train 3072; fine 3072 x 192 points, coarse
   3072 x 64, both through the full model), once for K2 and once for K4: each
   parameter's gradient of sum(tanh(raw) * w) through the kernels (K1 forward, K2
   backward, or K3 / K4, mapped through pack_params by autograd) against fp32
   autograd of the plain PyTorch query,
   max|d| / max|ref| <= 2e-2 per parameter (bench.py:397-401), with the bf16 plain
   version's error printed beside it; an instance-only loss gives exactly zero trunk,
   rgb and density gradients; two runs are bit-identical. Median times of K2's own
   launches over a stash the training forward wrote (ms), of the training forward
   (stash_fwd_ms) and the no-grad forward (fwd_ms), of the standalone entry (the two
   together, entry_ms, with its per-launch split from torch.profiler, launch_ms), of
   the query as a train step runs it (forward with gradients, then autograd's
   backward, fwd_bwd_ms), of the plain fp32 autograd backward, of the backward and the
   forward + backward through the bf16 addmm chain (the library yardsticks), and the
   bound: the backward's own matrix FLOPs over 989 TFLOP/s, or bytes over 3.35 TB/s,
   whichever is larger. The train phases print their peak device memory.
5. Train phase: the flagship train config (N_train 3072, N_samples 64,
   N_importance 128, over_penalize with tolerance = deta_w = 0.05, lrate 5e-4,
   perturb on) for 20 steps through dmnerf_tpu_torch.train on a synthetic DM-SR scene
   built in memory (256x256, 4 train views, 4 objects, ins_num 32, near 1, far 8).
   Exactly 2 launches of each kernel per step and one of K11 (the coarse and fine
   assignments), every logged loss finite (the instance loss included), and one step's
   full-loss gradients through the kernels within 2e-2 per parameter of the plain
   PyTorch query's, from the same parameters, batch and draws. Prints the steady ms per
   step and rays/s. Then K11 against its plain version on 1,000 seeded [2, 32, 32]
   batches (uniform costs, integer costs with ties, NaN and +-inf entries, wide costs;
   valid 0 ... 32), col4row equal, and timed at that step's own costs and valid count:
   device time from back-to-back launches (device_ms), the plain version's and the host
   scipy solve's (the step's earlier host round trip, a yardstick), and the bound: the
   Dijkstra iterations those costs need over the valid rows times one block-wide
   argmin's latency, measured by the kernel's probe entry.
6. Train phase under pallas_pe_mode = kernel: the same for 5 steps, with exactly 2
   launches of K3 and of K4 per step and none of K1 or K2.
7. Manipulation phase, on a synthetic DM-SR scene built in memory (256x256, 4
   objects, ins_num 32, near 1, far 8) at the flagship manipulation config
   (configs/manipulation/dmsr/manipulation_translation/study.txt: N_test 2048,
   N_samples 64, N_importance 128; target_label 1, an object of the scene):
   manipulator_eval over 2 views with K = 1 under pallas_pe_mode = kernel (exactly
   chunks x (3 + 3K) K3 launches per view) against the manipulated ground truth, and
   manipulator_demo over 2 frames with K = 2 (a translation and a sin deform) under
   the default mode (chunks x 9 K1 launches per frame). Every map finite and in
   range; one manipulated view with deterministic draws through the kernel query and
   through the plain PyTorch query on the card, its rgb and labels held to the render
   phase's bars (the target bundle's coarse rgb is printed beside them). Prints ms per
   manipulated view and rays/s.
8. pe_mode 'outside' kernel phase (K7, K5) at the flagship width, points between
   ScanNet's near 0 and far 9.5: K7 then K5 on the fine render chunk (2048 x 192,
   full model) and the coarse one (2048 x 64, sigma stub) against the fp32 plain
   version (max|d| <= 5e-3 * max(scale, 1)), the stub's sigma against the full
   model's (1e-5), K7 against its plain version (x lanes bit-equal to bf16(x), sin and
   cos lanes within 4e-3, pad column zero), and K5 over K7 against K1 on the same
   points and per-ray viewdirs (max|d| and the count of differing elements: K7 builds
   the bits of embed_rows, K1's embedding). Median times of K5, the plain versions and
   the bf16 addmm chain, beside their bounds. K7's time is its device time from 50
   back-to-back launches (device_ms; a single launch of tens of microseconds cannot be
   timed by one event pair), beside the wrapper's per-call time (call_ms, the host's
   work included), its bytes bound and its issue bound (the fast path of sincosf counted
   in cuobjdump -sass of a probe, 3 multires of them a point over 132 SMs x 4 x 32 lanes
   at the SM clock), the larger of the two, its share of it and the card.
9. pe_mode 'outside' backward phase (K6) at the training shapes (fine 3072 x 192,
   coarse 3072 x 64), as phase 4.
10. ScanNet train phase: configs/train/scannet/scene0010_00.txt under pallas_pe_mode
   = outside (N_train 3072 of which N_ins 921 labelled, N_samples 64, N_importance 128,
   crop 640x480, weakly_value 1.0, over_penalize, tolerance = deta_w = 0.05) for 5
   steps through dmnerf_tpu_torch.train on a synthetic ScanNet scene built in memory
   (640x480, 8 train and 1 test frame, 6 objects, half the labelled pixels dropped to
   -1, near 0, far 9.5): exactly 2 launches each of K7, K5 and K6 a step and none of
   K1-K4, every logged loss finite (the instance loss over the labelled suffix
   included), one step's gradients within 2e-2 of the plain query's; steady ms per
   step and rays/s.
11. ScanNet render phase: the test view, 640x480 (150 chunks of 2048 rays), through
   render_test with the crop mask under pallas_pe_mode = outside, with the weights of
   the ScanNet train phase: exactly 2 K7 and 2 K5 launches a chunk, every map finite
   and in range, and the same view through the plain PyTorch query on the card held
   to the render phase's bars. Prints ms per view, and the device time of one more
   kernel view by kernel (torch.profiler): K7's and K5's, the rest, and K7's share.
12. Mesh phase, at the flagship width (configs/test/dmsr/study.txt, near 1, far 8,
   N_importance 128, ins_num 32) with seeded weights on a synthetic DM-SR scene built
   in memory: make_sigma_query over the full 256^3 grid (build_grid, identity frame)
   in exactly 256 K1 launches of 65,536 points (1,024 rays of 64 samples, zero view
   dirs, sigma stub), its sigma against the fp32 plain sweep on the card (max|d| <=
   5e-3 * max(scale, 1)) with the share of grid points on the other side of the level,
   the stub's sigma against the full model's on one chunk (1e-5); the sweep's ms
   (CUDA events) and host ms, and K1's own device time in it (torch.profiler), which
   over the 256 launches is a launch's ms, beside its bound, one call's event-pair time
   (call_ms), the fp32 plain version's and the bf16 addmm chain's. At
   seeded weights the reference level 0.45 gives an empty surface (occupancy stays
   below 0.01), so the level is the 99.9th percentile of the kernel sweep's occupancy,
   printed. Then run_test's mesh mode at that level: a non-empty surface, mesh.ply
   and color_mesh.ply written and read back, exactly 256 + 2 x ceil(V / N_test) K1
   launches (the sweep, then the colour render of the V cleaned vertices), and the
   same vertex rays through the plain query on the card with at most 1% of the
   vertices on another argmax label. Prints the vertex and face counts, each host
   stage's seconds, the peak resident memory and the peak device memory.
13. Fused render phase (scripts/fused_render_probe_torch.py's view), at the flagship
   width (configs/test/dmsr/study.txt, ins_num 32, near 1, far 8, seeded weights): the
   first test view (256x256) of a synthetic DM-SR scene through make_fused_renderer
   (exactly one K8c and one K8f launch a chunk and no K1) and through
   make_image_renderer (K1) with the same weights: the fused view's maps finite and in
   range, its rgb PSNR >= 40 dB against the K1 view and at most 1% of its pixels on
   another argmax label; both views' ms (host clock, in turns) and, from one view of
   each under torch.profiler, the device activities a chunk, the busy ms and the idle
   share. Then K8c (the sigma stub's weights over the coarse depths) and K8f (the maps
   over the fine depths sample_pdf draws from K8c's weights) at the view's first chunk
   (2048 rays) against their bf16 plain versions (the same roundings) and their fp32
   plain versions, max|d| <= 5e-3 * max(scale, 1). The last sample's weight, T (1 -
   exp(-relu(sigma) 1e10 |d|)), jumps between 0 and T as sigma crosses 0; rays where the
   bf16 roundings of the query move it across (the fp32 and bf16 plain versions then
   disagree there beyond the bar) are counted and held to the bf16 plain version only
   (K8c: that sample only; K8f: the ray's maps). Each pass's device time from 50
   back-to-back launches (device_ms) beside K1's over the same products and the points
   the plain path forms (k1_device_ms: the pass without its point formation and
   compositing), the wrapper's per-call time, the fp32 plain version's, the library
   yardstick's (the bf16 addmm chain, then the PyTorch compositing) and the bound (executed matrix FLOPs over 989 TFLOP/s, or bytes over
   3.35 TB/s, whichever is larger). K8f also under both schedules of the forward
   template's consumers' products, lockstep and pipelined (its path's,
   fused_render.MAPS_SCHEDULE), in turns (schedule_turns): each one's device time and
   share of the bound, pipelined's maps bit for bit lockstep's, repeats bit-identical;
   and K8f's register, spill and wgmma-serialization lines from the build.
14. Head probe phase (scripts/head512_probe_torch.py and scripts/mfu_probe4_torch.py, a
   path of its own, probe_heads): K9 in its four modes (a: head [256, 513]; b: [256, 512]
   and a CUDA-core sigma dot; c: [256, 512]; d: [256, 512] and the n16 sigma layer) at the
   probe's 786,432 points, and K10 (the fused head: block-diagonal output, and split) at
   589,824 points with the operands of seeded flagship parameters: one launch a mode or
   variant through the wrappers, each against its fp32 plain version (5e-3 * max(scale,
   1)) and its bf16 one with exact sums (5e-3 of the scale, or twice the distance of
   PyTorch's fp32 matmul order from exact sums where that floor is higher: a bf16
   rounding that flips under another order runs through K9's eight layers), repeats
   bit-identical; device_ms, TFLOP/s on model and executed FLOPs, the bound, the fp32
   plain version's and the bf16 chain's times, and the two answers (a - c, b - c, d - c;
   split - block-diagonal). Then K10's variants under both schedules in turns (as K8f
   above; bits equal to lockstep's), and its answer under each. K10's path takes
   pipelined products (head_probes.HEADS_FUSED_SCHEDULE); K9's source builds lockstep.
15. Packed train phase (steps_per_dispatch), at the flagship train config of phase 5
   with steps_per_dispatch = i_print = 10: 3 packs (one CUDA graph replay of 10 whole
   steps each) from train()'s seeded state and generators against the same 30 steps one
   at a time from the same draws: parameters, Adam's moments and counts and every step's
   aux bit for bit; train() with steps_per_dispatch 10 over the same 30 steps logs 0,
   10, 20 and ends in the same state. One more pack under torch.profiler: exactly 20
   launches of K1's forward and of K2's bwd_data, 10 of K11, no device-to-host copy, one
   cudaGraphLaunch. Then 10 steps each way timed in turns (unpacked, packed, packed,
   unpacked: CUDA events, ms a step and rays/s, peak device memory) and profiled (device
   busy share, host runtime-API ms without the synchronising waits, cudaLaunchKernel
   calls a step), beside the card's name and power limit. The same checks (without the
   timing) for 2 packs of 5 ScanNet steps under pallas_pe_mode = outside: 10 launches
   each of K7, K5 and K6's bwd_data and 5 of K11 a pack.

The line before the last is a JSON object with each kernel's numbers and its
launches on each path; the last line is {"ok": true, "device": {...}}. Any failure
raises and exits non-zero.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
KERNEL_TOL = 5e-3            # kernel vs fp32 plain: max|d| <= 5e-3 * max(scale, 1)
STUB_TOL = 1e-5              # stub sigma vs full sigma: <= 1e-5 * max(sigma scale, 1)
MIN_PSNR_DB = 40.0           # kernel render vs plain render, rgb
MAX_LABEL_FLIP = 0.01        # share of pixels whose argmax instance label differs
GRAD_TOL = 2e-2              # parameter gradient, max|d| / max|ref| per parameter
TRAIN_STEPS = 20
KPE_TRAIN_STEPS = 5
SCANNET_TRAIN_STEPS = 5
SEED = 0


def _kernel_label(line: str) -> str:
    """A kernel's name in a line of ptxas output, with its template's arguments:
    <stash>, K7's <multires>, K8's <weights> / <maps> and the forward template's
    schedule (<pipelined>)."""
    m = re.search(r"\d([a-z_]+_kernel)", line)
    fn = m.group(1) + ("<stash>" if "Lb1E" in line else "") if m else ""
    mr = re.search(r"_kernelILi(\d+)E", line)     # K7's multires template
    fn += f"<{mr.group(1)}>" if mr else ""
    cm = re.search(r"Lb[01]ELi([12])E", line)     # K8's compositing epilogue
    fn += {"1": "<weights>", "2": "<maps>"}[cm.group(1)] if cm else ""
    sm = re.search(r"Lb[01]ELi\dELi(\d)E", line)  # the consumers' schedule
    fn += "<pipelined>" if sm and sm.group(1) == "1" else ""
    return fn


def register_lines(report: str) -> list:
    """(kernel, line) of each register and spill line of an ``nvcc -Xptxas -v`` report,
    and of each kernel whose wgmma ptxas serialized (its note C7511), the kernel named by
    ``_kernel_label``."""
    out, fn = [], ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = _kernel_label(line)
        if ("Used" in line and "registers" in line) or "spill stores" in line:
            out.append((fn, line.strip()))
        if "C7511" in line:
            out.append((_kernel_label(line), "wgmma serialized (ptxas C7511)"))
    return out


def _time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(launch, reps: int = 50, runs: int = 5) -> dict:
    """The device time of one launch, for kernels of microseconds, where an event pair
    around one call times the host: ``launch`` (no arguments) only enqueues. After a
    warm-up the card is held busy (``torch.cuda._sleep``) while the host enqueues
    ``reps`` launches back to back between two events; device_ms is the events' time
    over ``reps``, the median of ``runs`` such runs. enqueue_ms is the host's time per
    enqueue in the same runs: where it nears device_ms the queue ran dry."""
    import torch

    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)     # ≈ 1 ms of the card's clock: the queue fills
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            launch()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / reps)
        host.append((t1 - t0) * 1e3 / reps)
    return dict(device_ms=statistics.median(dev), enqueue_ms=statistics.median(host),
                device_ms_runs=dev)


def schedule_turns(launch) -> dict:
    """A kernel of the forward template under both schedules of its consumers' products
    in one call, in turns (lockstep, pipelined, pipelined, lockstep): ``launch(schedule)``
    enqueues one launch and returns its output. Each schedule's device time (``<name>_ms``,
    the mean of its two turns of ``device_ms``), whether pipelined's output equals
    lockstep's bit for bit and whether each schedule's repeats do."""
    import torch

    from dmnerf_tpu_torch.kernels.fused_mlp import LOCKSTEP, PIPELINED, SCHEDULE_NAMES

    order = [LOCKSTEP, PIPELINED]
    turns = {sc: [] for sc in order}
    for sched in order + order[::-1]:
        turns[sched].append(device_ms(lambda: launch(sched))["device_ms"])
    outs = {sched: [launch(sched), launch(sched)] for sched in order}
    torch.cuda.synchronize()
    res = {f"{SCHEDULE_NAMES[sc]}_ms": statistics.mean(t) for sc, t in turns.items()}
    res["turns_ms"] = {SCHEDULE_NAMES[sc]: t for sc, t in turns.items()}
    res["bits_equal_lockstep"] = bool(torch.equal(outs[PIPELINED][0], outs[LOCKSTEP][0]))
    res["repeats_bit_identical"] = all(bool(torch.equal(a, b)) for a, b in outs.values())
    return res


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes (A/B equality)."""
    import hashlib

    import torch

    flat = t.detach().contiguous().reshape(-1)
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()[:16]


def smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` of the first card."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


SINCOS_PROBE = r"""
extern "C" __global__ void sincos_probe(const float* __restrict__ a, float* s, float* c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float v = a[i];
#ifdef WITH_SINCOS
  float y, z;
  sincosf(v, &y, &z);
  s[i] = y;
  c[i] = z;
#else
  s[i] = v;
  c[i] = v;
#endif
}
"""


def _sass_fast_path(sass: str) -> int:
    """The instructions on the shortest path from the first instruction of the one
    function in ``sass`` (``cuobjdump -sass``) to an unpredicated EXIT, NOPs not
    counted. A predicated branch may go either way, so code behind one that the short
    path skips (sincosf's slow path for phases above ≈ 1e5) is not counted; a CALL
    counts as one instruction."""
    import collections

    ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", sass)]
    if not ins:
        raise AssertionError("no SASS instruction found")
    at = {a: i for i, (a, _) in enumerate(ins)}
    dist = {0: 0 if "NOP" in ins[0][1] else 1}
    queue = collections.deque([0])
    best = None
    while queue:
        i = queue.popleft()
        text = ins[i][1]
        pred = text.startswith("@")
        op = text.split()[1 if pred else 0]
        if op.startswith("EXIT"):
            best = dist[i] if best is None else min(best, dist[i])
            if not pred:
                continue
        nxt = []
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", text)
            if m is None or int(m.group(1), 16) not in at:
                raise AssertionError(f"branch without a target in the listing: {text}")
            nxt.append(at[int(m.group(1), 16)])
        if not op.startswith("BRA") or pred:
            nxt.append(i + 1)
        for j in nxt:
            if j >= len(ins):
                continue
            d = dist[i] + (0 if "NOP" in ins[j][1] else 1)
            if d < dist.get(j, 1 << 30):
                dist[j] = d
                queue.append(j)
    if best is None:
        raise AssertionError("no path to EXIT in the listing")
    return best


def sincosf_instructions(out_dir: str) -> dict:
    """SASS instructions of one accurate sincosf on its fast path, counted in
    ``cuobjdump -sass`` of a probe kernel built with the kernels' device flags (sm_90a,
    -O3, no fast math): the shortest path to EXIT with sincosf minus the same probe
    storing its input (the load, index and stores). The listings are written to
    ``out_dir``."""
    from dmnerf_tpu_torch.kernels import runtime

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "sincos_probe.cu")
    with open(src, "w") as f:
        f.write(SINCOS_PROBE)
    nvcc = runtime._nvcc()
    procs = {}
    for tag, flags in (("sincos", ["-DWITH_SINCOS"]), ("base", [])):
        cubin = os.path.join(out_dir, f"sincos_probe_{tag}.cubin")
        procs[tag] = (cubin, subprocess.Popen(
            [nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             *flags, "-o", cubin, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    counts = {}
    for tag, (cubin, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"sincos probe build failed:\n{out}")
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
        with open(os.path.join(out_dir, f"sincos_probe_{tag}.sass"), "w") as f:
            f.write(sass)
        counts[tag] = _sass_fast_path(sass)
    return dict(per_sincosf=counts["sincos"] - counts["base"], probe=counts["sincos"],
                probe_without=counts["base"])


def k7_bounds(P: int, multires: int, ep: int, sincosf_instr: int, n_sms: int,
              sm_mhz: float) -> dict:
    """K7's two bounds: bytes (12 in and 2 EP out a point over 3.35 TB/s) and issue
    (the fast path's instructions of 3 multires sincosf a point over the card's issue
    rate, n_sms x 4 schedulers x 32 lanes at the SM clock), the larger the bound."""
    t_bytes = (12 + 2 * ep) * P / PEAK_BYTES * 1e3
    t_issue = sincosf_instr * 3 * multires * P / (n_sms * 4 * 32 * sm_mhz * 1e6) * 1e3
    return dict(bytes_bound_ms=t_bytes, issue_bound_ms=t_issue, bound_ms=max(t_bytes, t_issue),
                bound_by="bytes" if t_bytes >= t_issue else "operations")


# the device launches of one backward call, by the kernel names of csrc/fused_mlp_bwd.cuh
# (and of the stashing forward of csrc/fused_mlp_fwd.cuh that the standalone entries run)
LAUNCH_KINDS = (("stash_fwd", ("fwd_stash_kernel", "fused_mlp_fwd_kernel")),
                ("bwd_data", ("bwd_data_kernel",)), ("dw", ("dw_kernel",)),
                ("reduce", ("namespace)::reduce_kernel", "sum_rows_kernel")))


def launch_split(fn, reps: int = 3, kinds=LAUNCH_KINDS) -> dict:
    """Device ms per call of ``fn`` by launch kind (``kinds``: (kind, kernel name parts)),
    from torch.profiler's CUDA activity (CUPTI sees the kernels of the ctypes libraries),
    averaged over ``reps`` calls after one warm-up call, with the launches per call;
    ``other`` is every other device activity, ``total`` all of it. Raises when the
    profiler saw no kernel of a known kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {kind: 0.0 for kind, _ in kinds}
    count = {kind: 0 for kind, _ in kinds}
    other = 0.0
    for evt in prof.events():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dur = evt.time_range.elapsed_us() / 1e3
        kind = next((k for k, names in kinds if any(n in evt.name for n in names)), None)
        if kind is None:
            other += dur
            continue
        ms[kind] += dur
        count[kind] += 1
    if not any(count.values()):
        raise AssertionError(f"torch.profiler saw none of the kernels {kinds} on the card")
    out = {k: v / reps for k, v in ms.items()}
    out["other"] = other / reps
    out["total"] = sum(out.values())
    out["launches_per_call"] = {k: v / reps for k, v in count.items()}
    return out


def query_macs(params) -> int:
    """Multiply-accumulates per point of the fused query's own products (no padding):
    trunk, M1 = [Wrf.Wrh1 | Wif.Wih | Wd], the viewdir contraction and the two outputs."""
    D = sum(1 for k in params if k.startswith("trunk_") and k.endswith("_w"))
    macs = sum(params[f"trunk_{i}_w"].numel() for i in range(D))
    W = params["density_w"].shape[0]
    Hr, Hi = params["rgb_hid_w"].shape[1], params["ins_hid_w"].shape[1]
    Ed = params["rgb_hid_w"].shape[0] - params["rgb_feat_w"].shape[1]
    C = params["ins_out_w"].shape[1]
    return macs + W * (Hr + Hi + 1) + Ed * Hr + Hr * 3 + Hi * C


def backward_macs(params) -> int:
    """Multiply-accumulates per point of the backward's own products: dW (the
    forward's products) and dX into the trunk, which the instance head does not
    reach: every trunk layer but the first into h, the head's rgb block and sigma
    into h, and the output layer into the head's activations."""
    D = sum(1 for k in params if k.startswith("trunk_") and k.endswith("_w"))
    W = params["density_w"].shape[0]
    Hr, Hi = params["rgb_hid_w"].shape[1], params["ins_hid_w"].shape[1]
    C = params["ins_out_w"].shape[1]
    return query_macs(params) + (D - 1) * W * W + W * (Hr + 1) + Hr * 3 + Hi * C


def library_query(packed, pts, viewdirs, mode="kernel_t"):
    """The same function as one bf16 torch.addmm per packed layer (cuBLAS), for
    library_ms only; the viewdir embedding per ray, repeated ('kernel_t', 'outside'),
    or of the per-point directions ('kernel')."""
    import torch

    from dmnerf_tpu_torch.kernels.fused_mlp import _embedding, _point_dirs, view_embedding

    N, S, _ = pts.shape
    bf = torch.bfloat16
    e = _embedding(pts.reshape(N * S, 3), packed.multires, packed.ep).to(bf)
    if mode == "kernel":
        ed = _embedding(_point_dirs(viewdirs, S), packed.multires_views, packed.edp).to(bf)
    else:
        ed = view_embedding(packed, viewdirs).to(bf).repeat_interleave(S, dim=0)
    return library_chain(packed, e, ed).reshape(N, S, packed.c4)


def library_chain(packed, e, ed):
    """The layer chain alone over bf16 embeddings e [P, EP], ed [P, EDP] -> raw
    [P, 4+C], one bf16 torch.addmm per packed layer (K5's library yardstick)."""
    import torch

    bf = torch.bfloat16
    b_all = packed.b.to(bf)
    h = sigma = None
    for layer in packed.layers:
        w = packed.w_bf16[layer.w_off:layer.w_off + layer.K * layer.N].view(layer.K, layer.N)
        b = b_all[layer.b_off:layer.b_off + layer.N]
        a = {"emb0": e, "plain": h, "sigma": h, "out": h}.get(layer.kind)
        if layer.kind == "split":
            a = torch.cat([h, e], dim=-1)
        elif layer.kind == "head":
            a = torch.cat([ed, h], dim=-1)
        y = torch.addmm(b, a, w)
        if layer.kind == "sigma":
            sigma = y[:, :1]
        elif layer.kind == "out":
            y[:, 3:4] = sigma
            return y[:, :packed.c4].float()
        else:
            h = torch.relu(y)
    raise ValueError("packed layer table has no output layer")


def _plain_embedded(packed, pts, dirs, dtype):
    """The plain versions of the 'outside' embeddings in ``dtype``: K7's e [P, EP] and
    the per-point viewdir table ed [P, EDP]."""
    from dmnerf_tpu_torch.kernels import fused_mlp as fm

    N, S, _ = pts.shape
    return (fm.pe_points_ref(packed, pts.reshape(N * S, 3), dtype),
            fm.point_view_embedding(packed, dirs, S, dtype))


def _kernel_embedded(packed, pts, dirs):
    """K7's e and the bf16 per-point viewdir table, as the 'outside' query builds them."""
    import torch

    from dmnerf_tpu_torch.kernels import fused_mlp as fm

    N, S, _ = pts.shape
    return (fm.pe_points(packed, pts.reshape(N * S, 3).contiguous()),
            fm.point_view_embedding(packed, dirs, S, torch.bfloat16))


def _plain_fwd(mode, packed, pts, dirs, dtype):
    """The plain version of the forward kernel(s) of ``mode``, raw [N, S, 4+C]."""
    from dmnerf_tpu_torch.kernels.fused_mlp import (
        _point_dirs, fused_query_kpe_ref, fused_query_pe_ref, fused_query_ref)

    if mode == "kernel_t":
        return fused_query_ref(packed, pts, dirs, dtype)
    N, S, _ = pts.shape
    if mode == "outside":
        return fused_query_pe_ref(packed, *_plain_embedded(packed, pts, dirs, dtype),
                                  dtype).reshape(N, S, -1)
    return fused_query_kpe_ref(packed, pts.reshape(N * S, 3), _point_dirs(dirs, S),
                               dtype).reshape(N, S, -1)


def _bwd(mode, packed, pts, dirs, g, plain_dtype=None):
    """(dw, db) of the backward kernel of ``mode`` (K2 / K4 / K6 over K7's embedding), or
    of its plain version in ``plain_dtype``."""
    from dmnerf_tpu_torch.kernels import fused_mlp as fm

    if mode == "kernel_t":
        if plain_dtype is None:
            return fm.fused_query_bwd(packed, pts, dirs, g)
        return fm.fused_query_bwd_ref(packed, pts, dirs, g, plain_dtype)
    N, S, _ = pts.shape
    if mode == "outside":
        if plain_dtype is None:
            return fm.fused_query_pe_bwd(packed, *_kernel_embedded(packed, pts, dirs),
                                         g.reshape(N * S, -1))
        return fm.fused_query_pe_bwd_ref(packed, *_plain_embedded(packed, pts, dirs, plain_dtype),
                                         g.reshape(N * S, -1), plain_dtype)
    args = (packed, pts.reshape(N * S, 3), fm._point_dirs(dirs, S), g.reshape(N * S, -1))
    if plain_dtype is None:
        return fm.fused_query_kpe_bwd(*args)
    return fm.fused_query_kpe_bwd_ref(*args, plain_dtype)


def _points(n_rays, n_samples, near, far, gen, device):
    """Rays from a camera at radius 4 looking at the origin; samples between near
    and far, sorted (fine-pass-like when random, coarse-like when linspace)."""
    import torch

    o = torch.tensor([4.0, 0.0, 1.6]).expand(n_rays, 3)
    d = -o + torch.randn((n_rays, 3), generator=gen) * 0.5
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.sort(near + (far - near) * torch.rand((n_rays, n_samples), generator=gen)).values
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    return pts.contiguous().to(device), d.contiguous().to(device)


def kernel_phase(cfg, device, mode="kernel_t"):
    """K1 (mode 'kernel_t') or K3 (mode 'kernel') against its plain version, timed."""
    import torch

    from dmnerf_tpu_torch.core.mlp import rgb_stub_params, sigma_stub_params
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.kernels.fused_mlp import fused_query, pack_params
    from dmnerf_tpu_torch.test import init_params

    pc, pf = init_params(cfg, device)
    gen = torch.Generator().manual_seed(SEED + 1)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    N = cfg.N_test
    fine_pts, fine_dirs = _points(N, cfg.N_samples + cfg.N_importance, cfg.near, cfg.far, gen, device)
    coarse_pts, coarse_dirs = _points(N, cfg.N_samples, cfg.near, cfg.far, gen, device)
    cases = [
        ("fine", pf, pack_params(pf, *args), fine_pts, fine_dirs),
        ("coarse_stub", sigma_stub_params(pc), pack_params(sigma_stub_params(pc), *args),
         coarse_pts, coarse_dirs),
    ]
    if mode == "kernel":
        cases.append(("fine_rgb_stub", rgb_stub_params(pf), pack_params(rgb_stub_params(pf), *args),
                      fine_pts, fine_dirs))
    tag = "kernel" if mode == "kernel_t" else "kernel kpe"
    results = {}
    with torch.no_grad():
        for name, params, packed, pts, dirs in cases:
            got = fused_query(packed, pts, dirs, mode)
            torch.cuda.synchronize()
            ref32 = _plain_fwd(mode, packed, pts, dirs, torch.float32)
            ref16 = _plain_fwd(mode, packed, pts, dirs, torch.bfloat16)
            lib = library_query(packed, pts, dirs, mode)
            scale = float(ref32.abs().max())
            err32 = float((got - ref32).abs().max())
            err16 = float((got - ref16).abs().max())
            errlib = float((lib - ref32).abs().max())
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: kernel output is not finite")
            if got.shape != ref32.shape:
                raise AssertionError(f"{name}: kernel shape {tuple(got.shape)} vs {tuple(ref32.shape)}")
            P = pts.shape[0] * pts.shape[1]
            flops = 2.0 * query_macs(params) * P
            # K3 reads a direction per point, K1 a viewdir per ray
            n_dirs = P if mode == "kernel" else dirs.shape[0]
            nbytes = (pts.numel() * 4 + n_dirs * 12 + packed.w_bf16.numel() * 2
                      + packed.b.numel() * 4 + got.numel() * 4)
            ms = _time_ms(lambda: fused_query(packed, pts, dirs, mode))
            plain_ms = _time_ms(lambda: _plain_fwd(mode, packed, pts, dirs, torch.float32), reps=5)
            library_ms = _time_ms(lambda: library_query(packed, pts, dirs, mode))
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            r = dict(points=P, out_scale=scale, max_abs_err=err32, max_abs_err_bf16_plain=err16,
                     library_max_abs_err=errlib, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                     gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / (ms * 1e-3) / 1e12)
            print(f"[{tag}] {name}: {json.dumps(r)}", flush=True)
            if err32 > KERNEL_TOL * max(scale, 1.0):
                raise AssertionError(f"{name}: kernel vs fp32 plain max|d| {err32:.3e} > "
                                     f"{KERNEL_TOL} * max({scale:.3e}, 1)")
            results[name] = r

        # the stubs' sigma column vs the full model's, both through the kernel
        stubs = [("sigma stub", cases[1][2], pack_params(pc, *args), coarse_pts, coarse_dirs)]
        if mode == "kernel":
            stubs.append(("rgb stub", cases[2][2], cases[0][2], fine_pts, fine_dirs))
        for what, stub_packed, full_packed, pts, dirs in stubs:
            full_raw = fused_query(full_packed, pts, dirs, mode)
            stub_raw = fused_query(stub_packed, pts, dirs, mode)
            full, stub = full_raw[..., 3], stub_raw[..., 3]
            sig_scale = float(full.abs().max())
            stub_err = float((stub - full).abs().max())
            extra = ""
            if what == "rgb stub":
                ins_err = float((stub_raw[..., 4:] - full_raw[..., 4:]).abs().max())
                extra = f"; instance logits max|d| {ins_err:.3e}"
            print(f"[{tag}] {what} sigma vs full sigma: max|d| {stub_err:.3e} at sigma scale "
                  f"{sig_scale:.3e}{extra}", flush=True)
            if stub_err > STUB_TOL * max(sig_scale, 1.0):
                raise AssertionError(f"{what} sigma max|d| {stub_err:.3e} > {STUB_TOL} * "
                                     f"max({sig_scale:.3e}, 1)")
    runtime.reset_launches()
    return results


def kernel_pe_phase(cfg, device, card):
    """K7 then K5 (pe_mode 'outside') against their plain versions and against K1,
    timed. Points between ScanNet's near 0 and far 9.5. K7's time is its device time
    from back-to-back launches (device_ms), beside the wrapper's per-call time
    (call_ms), its bytes and issue bounds (k7_bounds) and the card (``card``)."""
    import torch

    from dmnerf_tpu_torch.core.mlp import sigma_stub_params
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.test import init_params

    sincos = sincosf_instructions(os.path.join(REPO, "build", "sincos_probe"))
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"[kernel pe] sincosf fast path, SASS instructions: {json.dumps(sincos)}; {n_sms} SMs "
          f"at {sm_mhz} MHz", flush=True)
    near, far = 0.0, 9.5
    pc, pf = init_params(cfg, device)
    gen = torch.Generator().manual_seed(SEED + 7)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    N = cfg.N_test
    fine_pts, fine_dirs = _points(N, cfg.N_samples + cfg.N_importance, near, far, gen, device)
    coarse_pts, coarse_dirs = _points(N, cfg.N_samples, near, far, gen, device)
    stub = sigma_stub_params(pc)
    cases = [("fine", pf, fm.pack_params(pf, *args), fine_pts, fine_dirs),
             ("coarse_stub", stub, fm.pack_params(stub, *args), coarse_pts, coarse_dirs)]
    results = {}
    with torch.no_grad():
        for name, params, packed, pts, dirs in cases:
            P = pts.shape[0] * pts.shape[1]
            x = pts.reshape(P, 3).contiguous()
            e, ed = _kernel_embedded(packed, pts, dirs)
            got = fm._forward_pe(packed, e, ed).reshape(pts.shape[0], pts.shape[1], -1)
            torch.cuda.synchronize()
            if not torch.equal(fm.fused_query(packed, pts, dirs, "outside"), got):
                raise AssertionError(f"{name}: fused_query(pe_mode='outside') is not K7 then K5")

            # K7 against its plain version
            e32 = fm.pe_points_ref(packed, x, torch.float32)
            n = 3 * (1 + 2 * packed.multires)
            x_exact = torch.equal(e[:, :3], x.to(torch.bfloat16))
            sincos_err = float((e[:, 3:n].float() - e32[:, 3:n]).abs().max())
            pad_zero = not bool(e[:, n:].any())
            k7_bytes = x.numel() * 4 + e.numel() * 2
            e_timed = torch.empty_like(e)
            dev = device_ms(fm._pe_launcher(x, e_timed, packed.multires))
            per_sm = fm._PE_BLOCKS_PER_SM[(x.device.index, packed.multires, packed.ep)]
            k7 = dict(points=P, x_lanes_bit_equal=x_exact, sincos_max_abs_err=sincos_err,
                      pad_zero=pad_zero, max_abs_err=sincos_err, ms=dev["device_ms"], **dev,
                      call_ms=_time_ms(lambda: fm.pe_points(packed, x)),
                      plain_ms=_time_ms(lambda: fm.pe_points_ref(packed, x, torch.float32), reps=5),
                      **k7_bounds(P, packed.multires, packed.ep, sincos["per_sincosf"], n_sms,
                                  sm_mhz),
                      library_ms=None, mbytes=k7_bytes / 1e6, digest=digest(e), card=card,
                      blocks_per_sm=per_sm,
                      grid=fm._pe_plan(P, packed.ep, n_sms, per_sm)["grid"])
            k7["share_of_bound"] = k7["bound_ms"] / k7["device_ms"]
            k7["gbytes_per_s"] = k7_bytes / (k7["device_ms"] * 1e-3) / 1e9
            print(f"[kernel pe] {name} K7: {json.dumps(k7)}", flush=True)
            if not (x_exact and pad_zero and sincos_err <= 4e-3):
                raise AssertionError(f"{name}: K7 vs plain: x lanes bit-equal {x_exact}, pad zero "
                                     f"{pad_zero}, sin/cos max|d| {sincos_err:.3e} (want <= 4e-3)")
            if not torch.equal(e_timed, e):
                raise AssertionError(f"{name}: K7's timed launches wrote another e than pe_points")
            del e_timed

            # K5 over K7's embedding against the fp32 and bf16 plain versions and K1
            ref32 = _plain_fwd("outside", packed, pts, dirs, torch.float32)
            ref16 = _plain_fwd("outside", packed, pts, dirs, torch.bfloat16)
            k1 = fm.fused_query(packed, pts, dirs)
            scale = float(ref32.abs().max())
            err32 = float((got - ref32).abs().max())
            if not torch.isfinite(got).all() or got.shape != ref32.shape:
                raise AssertionError(f"{name}: K5 output not finite or of shape {tuple(got.shape)}")
            flops = 2.0 * query_macs(params) * P
            nbytes = (e.numel() * 2 + ed.numel() * 2 + packed.w_bf16.numel() * 2
                      + packed.b.numel() * 4 + got.numel() * 4)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            e_f, ed_f = e.float(), ed.float()
            k5 = dict(points=P, out_scale=scale, max_abs_err=err32,
                      max_abs_err_bf16_plain=float((got - ref16).abs().max()),
                      vs_k1_max_abs_diff=float((got - k1).abs().max()),
                      vs_k1_differing=int((got != k1).sum()), elements=got.numel(),
                      library_max_abs_err=float((library_chain(packed, e, ed).reshape(got.shape)
                                                 - ref32).abs().max()),
                      ms=_time_ms(lambda: fm._forward_pe(packed, e, ed)),
                      plain_ms=_time_ms(lambda: fm.fused_query_pe_ref(packed, e_f, ed_f,
                                                                      torch.float32), reps=5),
                      library_ms=_time_ms(lambda: library_chain(packed, e, ed)),
                      query_ms=_time_ms(lambda: fm.fused_query(packed, pts, dirs, "outside")),
                      k1_ms=_time_ms(lambda: fm.fused_query(packed, pts, dirs)),
                      bound_ms=max(t_ops, t_bytes),
                      bound_by="operations" if t_ops >= t_bytes else "bytes",
                      gflop=flops / 1e9, mbytes=nbytes / 1e6)
            k5["tflops"] = flops / (k5["ms"] * 1e-3) / 1e12
            print(f"[kernel pe] {name} K5: {json.dumps(k5)}", flush=True)
            if err32 > KERNEL_TOL * max(scale, 1.0):
                raise AssertionError(f"{name}: K5 vs fp32 plain max|d| {err32:.3e} > "
                                     f"{KERNEL_TOL} * max({scale:.3e}, 1)")
            results[name] = dict(k7=k7, k5=k5)
            del e, ed, e_f, ed_f

        # the stub's sigma column vs the full model's, both through K7 then K5
        full = fm.fused_query(fm.pack_params(pc, *args), coarse_pts, coarse_dirs, "outside")[..., 3]
        stub_sig = fm.fused_query(cases[1][2], coarse_pts, coarse_dirs, "outside")[..., 3]
        sig_scale = float(full.abs().max())
        stub_err = float((stub_sig - full).abs().max())
        print(f"[kernel pe] sigma stub sigma vs full sigma: max|d| {stub_err:.3e} at sigma scale "
              f"{sig_scale:.3e}", flush=True)
        if stub_err > STUB_TOL * max(sig_scale, 1.0):
            raise AssertionError(f"sigma stub sigma max|d| {stub_err:.3e} > {STUB_TOL} * "
                                 f"max({sig_scale:.3e}, 1)")
    runtime.reset_launches()
    return results


def slice_phase(cfg, device):
    import numpy as np
    import torch

    from dmnerf_tpu_torch.core.pipeline import make_torch_query_fn
    from dmnerf_tpu_torch.core.rays import rays_from_K
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.evaluation import render_test
    from dmnerf_tpu_torch.render.renderer import make_image_renderer
    from dmnerf_tpu_torch.test import init_params

    H = W = 256
    n_views = 2
    scene = build_dmsr_scene(n_train=1, n_test=n_views, H=H, W=W, n_objects=4, ins_num=32,
                             seed=SEED)
    cfg = cfg.replace(near=1.0, far=8.0, ins_num=scene.ins_num, perturb=0.0)
    pc, pf = init_params(cfg, device)
    ids = scene.i_test

    runtime.reset_launches()
    res = render_test(cfg, pc, pf, scene.poses[ids], scene.hwk, gt_imgs=scene.images[ids],
                      gt_labels=scene.gt_labels[ids], ins_rgbs=scene.ins_rgbs, savedir=None,
                      device=device)
    launches = dict(runtime.LAUNCHES)

    chunks = -(-H * W // cfg.N_test)
    want = 2 * chunks * n_views
    if launches["fused_mlp_fwd"] != want:
        raise AssertionError(f"fused_mlp_fwd launched {launches['fused_mlp_fwd']} times, want "
                             f"2 x {chunks} chunks x {n_views} views = {want}")
    for img in res["images"]:
        if img.shape != (H, W, 3) or not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
            raise AssertionError(f"rendered rgb out of range: shape {img.shape}, "
                                 f"[{img.min()}, {img.max()}]")

    # one view through the kernel and through the plain PyTorch query, on the card
    K = torch.as_tensor(scene.K, device=device)
    c2w = torch.as_tensor(scene.poses[ids[0]], device=device)
    rays_o, rays_d = rays_from_K(H, W, K, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    ours = make_image_renderer(cfg)(pc, pf, rays_o, rays_d)
    plain_q = make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    plain = make_image_renderer(cfg, query_fn=plain_q)(pc, pf, rays_o, rays_d)
    for name, out in (("kernel", ours), ("plain", plain)):
        for k in ("rgb", "ins"):
            v = out[k]
            if not torch.isfinite(v).all() or float(v.min()) < 0 or float(v.max()) > 1:
                raise AssertionError(f"{name} {k} map not finite in [0, 1]")
        d = out["depth"]
        if not torch.isfinite(d).all() or float(d.min()) < 0 or float(d.max()) > cfg.far * 1.0001:
            raise AssertionError(f"{name} depth map not finite in [0, far]")
    mse = float(torch.mean((ours["rgb"].double() - plain["rgb"].double()) ** 2))
    psnr = float("inf") if mse == 0 else float(-10.0 * np.log10(mse))
    flip = float((ours["ins"].argmax(-1) != plain["ins"].argmax(-1)).float().mean())
    depth_err = float((ours["depth"] - plain["depth"]).abs().max())

    ms = [t * 1e3 for t in res["times"]]
    out = dict(views=n_views, H=H, W=W, chunks_per_view=chunks, launches=launches,
               psnr=res["psnrs"], ssim=res["ssims"], ap=[list(a) for a in res["aps"]],
               ms_per_image=ms, rays_per_s=[H * W / (t * 1e-3) for t in ms],
               kernel_vs_plain=dict(rgb_psnr_db=psnr, label_flip_share=flip,
                                    depth_max_abs_err=depth_err))
    print(f"[slice] {json.dumps(out)}", flush=True)
    if psnr < MIN_PSNR_DB or flip > MAX_LABEL_FLIP:
        raise AssertionError(f"kernel render vs plain render: rgb PSNR {psnr:.2f} dB "
                             f"(want >= {MIN_PSNR_DB}), label flips {flip:.4f} "
                             f"(want <= {MAX_LABEL_FLIP})")
    return launches


def _leaf_grads(query, params, pts, dirs, w):
    """Gradients of sum(tanh(raw) * w) with respect to every parameter."""
    import torch

    pp = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    raw = query(pp, pts, dirs)
    grads = torch.autograd.grad((torch.tanh(raw) * w).sum(), list(pp.values()))
    return dict(zip(pp, grads))


def _plain16_leaf_grads(params, args, pts, dirs, w, mode):
    """The same gradients through the bf16 plain versions of both kernels of ``mode``."""
    import torch

    from dmnerf_tpu_torch.kernels.fused_mlp import pack_params

    pp = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    packed = pack_params(pp, *args)
    with torch.no_grad():
        raw = _plain_fwd(mode, packed, pts, dirs, torch.bfloat16)
        dw, db = _bwd(mode, packed, pts, dirs, (1.0 - torch.tanh(raw) ** 2) * w,
                      plain_dtype=torch.bfloat16)
    torch.autograd.backward([packed.w, packed.b], [dw, db])
    return {k: v.grad for k, v in pp.items()}


def _rel_err(got, want):
    """max over parameters of max|d| / max|ref|, the largest max|d|, and the largest
    max|ref| (the gradients' scale)."""
    rel = max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
              for k in want)
    return (rel, max(float((got[k] - want[k]).abs().max()) for k in want),
            max(float(want[k].abs().max()) for k in want))


def bwd_kernel_phase(cfg, device, mode="kernel_t"):
    """K2 (mode 'kernel_t'), K4 (mode 'kernel') or K6 (mode 'outside', over K7's
    embedding) against fp32 autograd of the plain query, its wall, its repeats and its
    times (K6's over embeddings made once, as the train step's backward reuses the
    forward's)."""
    import dataclasses

    import torch

    from dmnerf_tpu_torch.core.pipeline import make_fused_query_fn, make_torch_query_fn
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.kernels.fused_mlp import fused_query, pack_params
    from dmnerf_tpu_torch.test import init_params

    pc, pf = init_params(cfg, device)
    gen = torch.Generator().manual_seed(SEED + 2)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    N = cfg.N_train
    cases = [("fine", pf, *_points(N, cfg.N_samples + cfg.N_importance, cfg.near, cfg.far, gen, device)),
             ("coarse", pc, *_points(N, cfg.N_samples, cfg.near, cfg.far, gen, device))]
    tag = {"kernel_t": "bwd", "kernel": "bwd kpe", "outside": "bwd pe"}[mode]
    results = {}
    for name, params, pts, dirs in cases:
        packed = pack_params(params, *args)
        w = torch.linspace(0.5, 1.5, packed.c4, device=device)
        kernel = _leaf_grads(make_fused_query_fn(*args, mode), params, pts, dirs, w)
        plain = _leaf_grads(make_torch_query_fn(*args), params, pts, dirs, w)
        rel, err, scale = _rel_err(kernel, plain)
        rel16, err16, _ = _rel_err(_plain16_leaf_grads(params, args, pts, dirs, w, mode), plain)
        worst = max(plain, key=lambda k: float((kernel[k] - plain[k]).abs().max())
                    / max(float(plain[k].abs().max()), 1e-30))
        if not all(torch.isfinite(v).all() for v in kernel.values()):
            raise AssertionError(f"{name}: kernel gradients are not finite")

        # the wall: an instance-only loss reaches no trunk, rgb or density parameter
        pp = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        fused_query(pack_params(pp, *args), pts, dirs, mode)[..., 4:].sum().backward()
        leaks = [k for k, v in pp.items() if k.startswith(("trunk_", "rgb_", "density"))
                 and v.grad is not None and int(torch.count_nonzero(v.grad)) > 0]
        if leaks or float(pp["ins_out_w"].grad.abs().sum()) == 0:
            raise AssertionError(f"{name}: instance-head wall broken: {leaks}")

        with torch.no_grad():
            raw = fused_query(packed, pts, dirs, mode)
        g = ((1.0 - torch.tanh(raw) ** 2) * w).contiguous()
        first, second = _bwd(mode, packed, pts, dirs, g), _bwd(mode, packed, pts, dirs, g)
        same = torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])

        P = pts.shape[0] * pts.shape[1]
        # the backward's own launches over a stash the training forward wrote
        if mode == "outside":
            a, d = _kernel_embedded(packed, pts, dirs)
            emb = (a, d)
            in_bytes = a.numel() * 2 + d.numel() * 2

            def entry():
                return fm.fused_query_pe_bwd(packed, a, d, g.reshape(P, -1))
        else:
            a, d = fm._kernel_inputs(packed, pts, dirs, mode)
            emb = ()
            # K4 reads a direction per point, K2 a viewdir per ray
            in_bytes = pts.numel() * 4 + (P if mode == "kernel" else dirs.shape[0]) * 12

            def entry():
                return _bwd(mode, packed, pts, dirs, g)
        n_s = (pts.shape[0], pts.shape[1]) if mode == "kernel_t" else (P, 1)
        _, plan, stash = fm._stash_forward(mode, packed, a, d, *n_s)
        g_flat = g.reshape(P, -1)
        ms = _time_ms(lambda: fm._launch_bwd(mode, packed, plan, stash, g_flat, *emb), reps=5)
        stash_fwd_ms = _time_ms(lambda: fm._stash_forward(mode, packed, a, d, *n_s), reps=5)
        del stash
        entry_ms = _time_ms(entry, reps=5)
        launch_ms = launch_split(entry)
        with torch.no_grad():
            fwd_ms = _time_ms(lambda: fused_query(packed, pts, dirs, mode))
        # the query as a train step runs it: the training forward, then autograd's backward
        pk = dataclasses.replace(packed, w=packed.w.detach().requires_grad_(True),
                                 b=packed.b.detach().requires_grad_(True))
        fwd_bwd_ms = _time_ms(lambda: torch.autograd.grad(fused_query(pk, pts, dirs, mode),
                                                          [pk.w, pk.b], g), reps=5)
        del a, d, emb, pk
        pp = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        raw32 = make_torch_query_fn(*args)(pp, pts, dirs)
        plain_ms = _time_ms(lambda: torch.autograd.grad(raw32, list(pp.values()), g,
                                                        retain_graph=True), reps=5)
        del raw32
        lib = dataclasses.replace(packed, w_bf16=packed.w_bf16.detach().clone().requires_grad_(True),
                                  b=packed.b.detach().clone().requires_grad_(True))
        raw16 = library_query(lib, pts, dirs, mode)
        library_ms = _time_ms(lambda: torch.autograd.grad(raw16, [lib.w_bf16, lib.b], g,
                                                          retain_graph=True), reps=5)
        del raw16
        library_fwd_bwd_ms = _time_ms(lambda: torch.autograd.grad(
            library_query(lib, pts, dirs, mode), [lib.w_bf16, lib.b], g), reps=5)

        flops = 2.0 * backward_macs(params) * P
        nbytes = (in_bytes + g.numel() * 4 + packed.w_bf16.numel() * 2
                  + packed.b.numel() * 4 + packed.w.numel() * 4 + packed.b.numel() * 4)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        r = dict(points=P, max_rel_err=rel, max_abs_err=err, grad_scale=scale, worst_param=worst,
                 max_rel_err_bf16_plain=rel16, max_abs_err_bf16_plain=err16, bit_identical=same,
                 ms=ms, launch_ms=launch_ms, entry_ms=entry_ms, fwd_ms=fwd_ms,
                 stash_fwd_ms=stash_fwd_ms, fwd_bwd_ms=fwd_bwd_ms, plain_ms=plain_ms,
                 library_ms=library_ms, library_fwd_bwd_ms=library_fwd_bwd_ms,
                 bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                 gflop=flops / 1e9, tflops=flops / (ms * 1e-3) / 1e12)
        print(f"[{tag}] {name}: {json.dumps(r)}", flush=True)
        if rel > GRAD_TOL or not same:
            raise AssertionError(f"{tag} {name}: gradient max rel err {rel:.3e} (want <= {GRAD_TOL}), "
                                 f"bit-identical repeats: {same}")
        results[name] = r
        del kernel, plain
        torch.cuda.empty_cache()
    runtime.reset_launches()
    return results


# the kernels each train step launches twice (coarse and fine), per pallas_pe_mode
STEP_KERNELS = {None: ("fused_mlp_fwd", "fused_mlp_bwd"),
                "kernel": ("fused_mlp_fwd_kpe", "fused_mlp_bwd_kpe"),
                "outside": ("fused_pe", "fused_mlp_fwd_pe", "fused_mlp_bwd_pe")}


def scannet_scene(cfg):
    """The synthetic ScanNet scene of the ScanNet phases, built in memory at the
    config's 640x480: 8 train and 1 test frame, 6 objects, half of the labelled pixels
    dropped to -1."""
    from dmnerf_tpu_torch.data.synthetic import build_scannet_scene

    return build_scannet_scene(cfg, n_train=8, n_test=1, H=480, W=640, n_objects=6, seed=SEED,
                               unlabeled_frac=0.5)


def train_setup(pe_mode, dataset, **run):
    """(cfg, scene) of a train phase: the flagship DM-SR train config
    (configs/train/dmsr/study.txt) on a synthetic DM-SR scene, or the ScanNet one
    (configs/train/scannet/scene0010_00.txt) on the synthetic ScanNet scene, both built
    in memory, under ``pe_mode``; ``run`` overrides config keys (basedir, N_iters, ...)."""
    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene

    run = dict(dict(lrate=5e-4, perturb=1.0, i_save=10 ** 9, i_test=10 ** 9,
                    expname="chip_smoke", pallas_pe_mode=pe_mode), **run)
    if dataset == "scannet":
        cfg = load_config(os.path.join(REPO, "configs", "train", "scannet", "scene0010_00.txt"),
                          **run)
        scene = scannet_scene(cfg)
        return cfg.replace(ins_num=scene.ins_num), scene
    scene = build_dmsr_scene(n_train=4, n_test=1, H=256, W=256, n_objects=4, ins_num=32,
                             seed=SEED)
    return load_config(os.path.join(REPO, "configs", "train", "dmsr", "study.txt"),
                       near=1.0, far=8.0, ins_num=scene.ins_num, **run), scene


def steady_step_ms(cfg, scene, params_coarse, params_fine, device, step=0, n=13, warmup=3):
    """Host-clock ms of ``n - warmup`` synchronised train steps after ``warmup`` ones,
    from a copy of the given parameters."""
    import torch

    from dmnerf_tpu_torch.render.trainstep import create_train_state, make_train_step
    from dmnerf_tpu_torch.train import make_sampler

    sampler, n_ins = make_sampler(cfg, scene, device)
    st = create_train_state(cfg, params_coarse, params_fine, step)   # copies the parameters
    step_fn = make_train_step(cfg, N_ins=n_ins)
    gb, gs = torch.Generator().manual_seed(SEED + 5), torch.Generator(device=device).manual_seed(SEED + 6)
    times = []
    for i in range(n):
        b = sampler(gb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(st, b, generator=gs)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def train_phase(device, pe_mode=None, steps=TRAIN_STEPS, dataset="dmsr"):
    """``steps`` flagship training steps through dmnerf_tpu_torch.train under
    ``pe_mode``, on a synthetic DM-SR scene (configs/train/dmsr/study.txt) or ScanNet
    scene (configs/train/scannet/scene0010_00.txt, the crop sampler): launches, losses,
    one step's gradients vs the plain query, step ms."""
    import tempfile

    import numpy as np
    import torch

    from dmnerf_tpu_torch.core.pipeline import make_query_fn, make_torch_query_fn, render_rays
    from dmnerf_tpu_torch.core.sampling import z_val_sample
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.objfield.losses import compact_one_hot, pairwise_costs
    from dmnerf_tpu_torch.render.trainstep import compute_losses
    from dmnerf_tpu_torch.train import make_sampler, train

    with tempfile.TemporaryDirectory() as tmp:
        cfg, scene = train_setup(pe_mode, dataset, basedir=tmp, N_iters=steps, i_print=1)
        runtime.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state = train(cfg, scene, device)
        torch.cuda.synchronize()
        train_s = time.time() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = dict(runtime.LAUNCHES)
        with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    for name in runtime.COUNTED:
        want = 2 * steps if name in STEP_KERNELS[pe_mode] else steps if name == "assignment" else 0
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times in {steps} train "
                                 f"steps under pallas_pe_mode={pe_mode}, want {want}")
    keys = ("total_loss", "rgb_loss", "ins_loss", "emptiness_loss", "psnr_fine")
    if len(recs) != steps or not all(np.isfinite(r[k]) for r in recs for k in keys):
        raise AssertionError(f"train losses not all finite over {len(recs)} logged steps")

    # one step's gradients, kernel query vs plain query: same parameters, batch, draws
    sampler, n_ins = make_sampler(cfg, scene, device)
    batch = sampler(torch.Generator().manual_seed(SEED + 3))
    gdev = torch.Generator(device=device).manual_seed(SEED + 4)
    u_z = torch.rand((cfg.N_train, cfg.N_samples), generator=gdev, device=device)
    u_pdf = torch.rand((cfg.N_train, cfg.N_importance), generator=gdev, device=device)
    z = z_val_sample(cfg.N_train, cfg.near, cfg.far, cfg.N_samples, device=device)

    def step_grads(query_fn):
        pc = {k: v.detach().clone().requires_grad_(True) for k, v in state.params_coarse.items()}
        pf = {k: v.detach().clone().requires_grad_(True) for k, v in state.params_fine.items()}
        info = render_rays(pc, pf, batch.rays_o, batch.rays_d, z, query_fn,
                           N_importance=cfg.N_importance, perturb=True, u_z=u_z, u_pdf=u_pdf)
        total, aux = compute_losses(cfg, info, batch, n_ins)
        grads = torch.autograd.grad(total, [*pc.values(), *pf.values()])
        names = [f"coarse.{k}" for k in pc] + [f"fine.{k}" for k in pf]
        return dict(zip(names, grads)), {k: float(v) for k, v in aux.items()}

    gk, aux_k = step_grads(make_query_fn(cfg))
    gp, aux_p = step_grads(make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth,
                                               tuple(cfg.skips)))
    rel, err, _ = _rel_err(gk, gp)
    worst = max(gp, key=lambda k: float((gk[k] - gp[k]).abs().max())
                / max(float(gp[k].abs().max()), 1e-30))

    times = steady_step_ms(cfg, scene, state.params_coarse, state.params_fine, device, state.step)
    step_ms = statistics.median(times)
    k11 = None
    if dataset == "dmsr" and pe_mode is None:
        # the step's own two cost matrices and valid count, as the instance loss forms them
        with torch.no_grad():
            info = render_rays(state.params_coarse, state.params_fine, batch.rays_o, batch.rays_d,
                               z, make_query_fn(cfg), N_importance=cfg.N_importance, perturb=True,
                               u_z=u_z, u_pdf=u_pdf)
            gt_ins, valid, _ = compact_one_hot(batch.target_i, cfg.ins_num)
            cost = sum(pairwise_costs(torch.stack([info["ins_coarse"], info["ins_fine"]]), gt_ins))
        k11 = assignment_phase(cfg, device, cost.contiguous(), valid)

    out = dict(steps=steps, pe_mode=pe_mode, dataset=dataset, N_ins=n_ins,
               H=scene.H, W=scene.W, ins_num=cfg.ins_num, launches=launches, train_s=train_s,
               first=recs[0], last=recs[-1],
               kernel_vs_plain=dict(max_rel_err=rel, max_abs_err=err, worst_param=worst,
                                    total_kernel=aux_k["total_loss"], total_plain=aux_p["total_loss"],
                                    ins_kernel=aux_k["ins_loss"], ins_plain=aux_p["ins_loss"]),
               step_ms=step_ms, step_ms_range=[min(times), max(times)], peak_mem_gb=peak_gb,
               rays_per_s=cfg.N_train / (step_ms * 1e-3))
    tag = "train scannet" if dataset == "scannet" else "train" if pe_mode is None else "train kpe"
    print(f"[{tag}] {json.dumps(out)}", flush=True)
    if rel > GRAD_TOL:
        raise AssertionError(f"train step gradients, kernel vs plain query: max rel err {rel:.3e} "
                             f"(want <= {GRAD_TOL}) at {worst}")
    return launches, scene, state, k11


ASSIGNMENT_BATCHES = 1000   # seeded [2, ins_num, ins_num] batches K11 is held to


def _assignment_cases(n, count, seed=SEED):
    """``count`` seeded (costs [2, n, n] fp32, valid) batches: in turn uniform costs,
    integer costs with ties, integer costs with NaN and +-inf entries, and wide normal
    costs; valid runs 0 ... n."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cases = []
    for b in range(count):
        kind = b % 4
        if kind == 0:
            c = rng.rand(2, n, n)
        elif kind == 1:
            c = rng.randint(0, 3, (2, n, n))
        elif kind == 2:
            c = rng.randint(0, 4, (2, n, n)).astype(np.float64)
            m = rng.rand(2, n, n)
            c[m < 0.05], c[(m >= 0.05) & (m < 0.08)], c[(m >= 0.08) & (m < 0.11)] = \
                np.nan, np.inf, -np.inf
        else:
            c = rng.randn(2, n, n) * 1e3
        cases.append((c.astype(np.float32), b % (n + 1)))
    return cases


def assignment_phase(cfg, device, step_cost, step_valid):
    """K11 against its plain version on ASSIGNMENT_BATCHES seeded batches (col4row equal),
    then timed at a train step's own costs: device time from back-to-back launches, the
    plain version's and the host scipy solve's (the yardstick: the step's earlier host
    round trip), and the bound: the Dijkstra iterations these costs need over the valid
    rows times one block-wide argmin's latency (the probe's, measured)."""
    import torch

    from dmnerf_tpu_torch.kernels import assignment as asg
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.objfield.hungarian import masked_assignment
    from dmnerf_tpu_torch.objfield.metrics import _lsa_rect

    n = cfg.ins_num
    differing, worst = 0, 0
    for c, valid in _assignment_cases(n, ASSIGNMENT_BATCHES):
        cost = torch.from_numpy(c)
        got = masked_assignment(cost.to(device), torch.tensor(valid, device=device)).cpu()
        want = asg.masked_assignment_ref(cost, valid)
        if not torch.equal(got, want):
            differing += 1
            worst = max(worst, int((got - want).abs().max()))
    valid_i = int(step_valid)
    iterations = []
    asg.masked_assignment_ref(step_cost.cpu(), valid_i, iterations)
    valid_t = torch.full((2,), valid_i, dtype=torch.int32, device=device)
    dev = device_ms(lambda: asg.assignment(step_cost, valid_t))
    probe_out = torch.empty(1, device=device)
    threads = -(-n // 32) * 32
    probe_iters = 1000
    probe = device_ms(lambda: asg.argmin_probe(threads, probe_iters, probe_out), reps=10)
    argmin_us = probe["device_ms"] * 1e3 / probe_iters
    t_serial = max(iterations) * argmin_us * 1e-3
    nbytes = step_cost.numel() * 4 + 2 * 4 + 2 * n * 8
    t_bytes = nbytes / PEAK_BYTES * 1e3

    def host_solve():
        host = step_cost.cpu().numpy()
        for m in host:
            _lsa_rect(m[:valid_i])
    runtime.reset_launches()
    r = dict(batches=ASSIGNMENT_BATCHES, n=n, differing_batches=differing, max_abs_err=worst,
             step_valid=valid_i, step_dijkstra_iterations=iterations,
             ms=dev["device_ms"], device_us=dev["device_ms"] * 1e3, enqueue_ms=dev["enqueue_ms"],
             plain_ms=_time_ms(lambda: asg.masked_assignment_ref(step_cost.cpu(), valid_i), reps=5),
             host_scipy_ms=_time_ms(host_solve, reps=20),
             argmin_latency_us=argmin_us, argmin_probe_threads=threads,
             bound_ms=max(t_serial, t_bytes), bound_by="operations" if t_serial >= t_bytes else "bytes",
             library_ms=None)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print(f"[assignment] {json.dumps(r)}", flush=True)
    if differing:
        raise AssertionError(f"K11: col4row differs from its plain version in {differing} of "
                             f"{ASSIGNMENT_BATCHES} batches")
    return r


PACK_STEPS = 10     # steps_per_dispatch (and i_print) of the flagship pack
PACKS = 3
SCANNET_PACK = (5, 2)   # P and packs of the ScanNet pack under 'outside'


def _aux_rows(auxs):
    """A runner's auxs as a [P, keys] copy."""
    import torch

    return torch.stack(list(auxs.values()), -1).clone()


def _bits(t):
    import torch

    return t.detach().reshape(-1).view(torch.int32) if t.dtype == torch.float32 else t.detach()


def _state_diffs(a, b):
    """The tensors of two train states (parameters, Adam moments and counts) whose bits
    differ, with their largest difference."""
    diffs = {}
    for which in ("params_coarse", "params_fine"):
        pa, pb = getattr(a, which), getattr(b, which)
        for k in pa:
            sa, sb = a.opt.state[pa[k]], b.opt.state[pb[k]]
            for name, ta, tb in [("param", pa[k], pb[k])] + [(m, sa[m], sb[m]) for m in sa]:
                if not _equal_bits(ta, tb):
                    diffs[f"{which}.{k}.{name}"] = float((ta.double() - tb.double()).abs().max())
    if a.step != b.step:
        diffs["step"] = abs(a.step - b.step)
    return diffs


def _equal_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def profile_calls(fn) -> dict:
    """``fn()`` once under torch.profiler (host and device): the device kernels and
    copies by name, the host's CUDA runtime calls by name with their ms, the device's
    busy ms (the union of its activity) and the traced wall ms."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmnerf_tpu_torch.tools.profile_step import _union_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    host_names = {e.name for e in events if e not in on_device}
    kernels, copies, api, api_ms, intervals = (collections.Counter(), collections.Counter(),
                                               collections.Counter(), collections.Counter(), [])
    for e in on_device:
        if e.name in host_names:
            continue
        intervals.append((e.time_range.start, e.time_range.end))
        (copies if e.name.startswith(("Memcpy", "Memset")) else kernels)[e.name] += 1
    for e in events:
        if e not in on_device and e.name.startswith("cuda"):
            api[e.name] += 1
            api_ms[e.name] += e.time_range.elapsed_us() / 1e3
    busy = _union_ms(intervals)
    # the synchronising calls wait for the device; the rest is the host's own API work
    work_ms = sum(ms for name, ms in api_ms.items() if "Synchronize" not in name)
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_busy_share=busy / wall_ms,
                host_api_ms=work_ms, api=dict(api), api_ms=dict(api_ms),
                kernels=dict(kernels), copies=dict(copies))


def _count(names: dict, part: str) -> int:
    return sum(n for k, n in names.items() if part in k)


def packed_train_phase(device, card, pe_mode=None, dataset="dmsr", P=PACK_STEPS, packs=PACKS,
                       timed=True):
    """Phase 15: ``packs`` packs of P whole train steps (one CUDA graph replay each)
    against the same steps one by one, from train()'s seeded state and generators:
    parameters, Adam's moments and counts and every step's aux bit for bit; train() with
    steps_per_dispatch = P over the same steps, which must end in the same state; one
    more pack under torch.profiler (2P K1 or K5 forwards, 2P bwd_data, P K11, no
    device-to-host copy, one cudaGraphLaunch); then, when ``timed``, P steps each way
    timed in turns (unpacked, packed, packed, unpacked) and profiled."""
    import tempfile

    import torch

    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.packing import StepRunner
    from dmnerf_tpu_torch.render.trainstep import create_train_state, make_train_step
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.train import make_packed_steps, make_sampler, train

    tmp = tempfile.TemporaryDirectory()
    cfg, scene = train_setup(pe_mode, dataset, basedir=tmp.name, N_iters=packs * P, i_print=P,
                             steps_per_dispatch=P)
    sampler, n_ins = make_sampler(cfg, scene, device)

    def start():
        """train()'s start: its seeded parameters and generators."""
        return (create_train_state(cfg, *init_params(cfg, device)),
                torch.Generator().manual_seed(cfg.seed + 1),
                torch.Generator(device=device).manual_seed(cfg.seed + 2))

    st_u, gb_u, gs_u = start()
    single = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), device, 1)
    aux_u = torch.cat([_aux_rows(single(st_u, gb_u, gs_u)) for _ in range(packs * P)])
    st_p, gb_p, gs_p = start()
    packed, P_eff = make_packed_steps(cfg, sampler, n_ins, device)
    if P_eff != P:
        raise AssertionError(f"pack of {P_eff} steps, want {P}")
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    aux_p = [_aux_rows(packed(st_p, gb_p, gs_p))]
    torch.cuda.synchronize()
    first_pack_s = time.perf_counter() - t0       # warm-up, capture and the first replay
    first_pack_mem = dict(peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                          reserved_growth_gb=(torch.cuda.memory_reserved() - reserved0) / 1e9)
    aux_p = torch.cat(aux_p + [_aux_rows(packed(st_p, gb_p, gs_p)) for _ in range(packs - 1)])
    torch.cuda.synchronize()
    keys = list(single.keys)
    bad_steps = (_bits(aux_u).view(aux_u.shape) != _bits(aux_p).view(aux_p.shape)).any(-1)
    diffs = _state_diffs(st_u, st_p)
    out = dict(card=card, dataset=dataset, pe_mode=pe_mode, P=P, packs=packs,
               N_train=cfg.N_train, first_pack_s=first_pack_s, first_pack_memory=first_pack_mem,
               state_tensors_differing=len(diffs),
               aux_steps_differing=int(bad_steps.sum()),
               aux_step0=dict(zip(keys, aux_p[0].tolist())),
               aux_last=dict(zip(keys, aux_p[-1].tolist())))
    if diffs or bool(bad_steps.any()):
        first = int(bad_steps.nonzero()[0]) if bool(bad_steps.any()) else None
        out.update(first_differing_step=first, differing=dict(list(diffs.items())[:12]),
                   aux_first_unpacked=None if first is None else aux_u[first].tolist(),
                   aux_first_packed=None if first is None else aux_p[first].tolist())
        print(f"[packed train] {json.dumps(out)}", flush=True)
        raise AssertionError(f"packed steps differ from the same steps one by one ({dataset}): "
                             f"{len(diffs)} state tensors, {int(bad_steps.sum())} steps' auxs")
    if not all(torch.isfinite(aux_p[:, keys.index(k)]).all() for k in ("total_loss", "ins_loss")):
        raise AssertionError("packed steps: losses not finite")

    # the entry point: train() with steps_per_dispatch = P from the same start ends where
    # the runners did
    runtime.reset_launches()
    state = train(cfg, scene, device)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line)["step"] for line in f]
    tmp.cleanup()
    if logged != list(range(0, packs * P, P)):
        raise AssertionError(f"train() with packs of {P} logged steps {logged}")
    if _state_diffs(st_u, state):
        raise AssertionError("train() with steps_per_dispatch ended in another state than the "
                             "runners")
    del state
    out["train_logged_steps"] = logged
    out["train_launches_counted"] = {k: v for k, v in launches.items() if v}

    # one more pack under the profiler
    prof = profile_calls(lambda: packed(st_p, gb_p, gs_p))
    k = prof["kernels"]
    fwd = "fused_pe_kernel" if pe_mode == "outside" else None
    counts = {"fused_mlp_fwd_kernel": _count(k, "fused_mlp_fwd_kernel"),
              "bwd_data_kernel": _count(k, "bwd_data_kernel"),
              "assignment_kernel": _count(k, "assignment_kernel"),
              "device_to_host_copies": _count(prof["copies"], "DtoH"),
              "cudaGraphLaunch": prof["api"].get("cudaGraphLaunch", 0)}
    want = {"fused_mlp_fwd_kernel": 2 * P, "bwd_data_kernel": 2 * P, "assignment_kernel": P,
            "device_to_host_copies": 0, "cudaGraphLaunch": 1}
    if fwd:
        counts[fwd], want[fwd] = _count(k, fwd), 2 * P
    out["pack_profile"] = dict(counts=counts, activities=sum(k.values()),
                               copies=prof["copies"], api=prof["api"])
    if counts != want:
        print(f"[packed train] {json.dumps(out)}", flush=True)
        raise AssertionError(f"a pack's device activity {counts}, want {want}")

    if timed:
        def unpacked():
            for _ in range(P):
                single(st_u, gb_u, gs_u)

        def one_pack():
            packed(st_p, gb_p, gs_p)

        turns = []
        for name, fn in (("unpacked", unpacked), ("packed", one_pack), ("packed", one_pack),
                         ("unpacked", unpacked)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start_e, end_e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start_e.record()
            fn()
            end_e.record()
            end_e.synchronize()
            ms = start_e.elapsed_time(end_e) / P
            turns.append(dict(mode=name, ms_per_step=ms, host_ms_per_step=(time.perf_counter() - t0)
                              * 1e3 / P, rays_per_s=cfg.N_train / (ms * 1e-3),
                              peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                              reserved_gb=torch.cuda.memory_reserved() / 1e9))
        out["turns"] = turns
        for name, fn in (("unpacked", unpacked), ("packed", one_pack)):
            p = profile_calls(fn)
            out[f"profile_{name}"] = dict(
                wall_ms_per_step=p["wall_ms"] / P, device_busy_ms_per_step=p["device_busy_ms"] / P,
                device_busy_share=p["device_busy_share"], host_api_ms_per_step=p["host_api_ms"] / P,
                cudaLaunchKernel_per_step=p["api"].get("cudaLaunchKernel", 0) / P,
                runtime_calls_per_step={a: n / P for a, n in p["api"].items()},
                device_activities_per_step=(sum(p["kernels"].values()) + sum(p["copies"].values())) / P)
    del packed, single
    print(f"[packed train] {json.dumps(out)}", flush=True)
    return launches, out


def render_scannet_phase(device, scene, params_coarse, params_fine):
    """The ScanNet test view through render_test with the crop mask under pallas_pe_mode
    = outside (K7, K5), and through the plain PyTorch query on the card, with the
    weights of the ScanNet train phase. The seeded init weights make a poor yardstick
    at this scene: their sigma sits near 0, so the last sample's 1e10 distance turns a
    bf16-sized change of sigma into a whole-ray change, and their instance logits are
    near-tied. The phase prints their comparison beside the trained one, held to no
    bar."""
    import numpy as np
    import torch

    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.core.pipeline import make_torch_query_fn
    from dmnerf_tpu_torch.core.rays import rays_from_K
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.evaluation import render_test
    from dmnerf_tpu_torch.render.renderer import make_image_renderer
    from dmnerf_tpu_torch.test import init_params

    cfg = load_config(os.path.join(REPO, "configs", "test", "scannet", "scene0010_00.txt"),
                      pallas_pe_mode="outside", perturb=0.0, ins_num=scene.ins_num)
    pc = {k: v.detach() for k, v in params_coarse.items()}
    pf = {k: v.detach() for k, v in params_fine.items()}
    ids = scene.i_test
    H, W = scene.H, scene.W

    runtime.reset_launches()
    res = render_test(cfg, pc, pf, scene.poses[ids], scene.hwk, gt_imgs=scene.images[ids],
                      gt_labels=scene.gt_labels[ids], ins_rgbs=scene.ins_rgbs, savedir=None,
                      crop_mask=scene.crop_mask, device=device, verbose=False)
    launches = dict(runtime.LAUNCHES)
    chunks = -(-H * W // cfg.N_test)
    for name in runtime.COUNTED:
        want = 2 * chunks * len(ids) if name in ("fused_pe", "fused_mlp_fwd_pe") else 0
        if launches[name] != want:
            raise AssertionError(f"ScanNet render: {name} launched {launches[name]} times, want "
                                 f"{want} ({chunks} chunks x {len(ids)} views)")
    for img in res["images"]:
        if img.shape != (cfg.crop_height, cfg.crop_width, 3):
            raise AssertionError(f"ScanNet render: crop image of shape {img.shape}")
        _check_maps("ScanNet render", rgb=img)

    K = torch.as_tensor(scene.K, device=device)
    rays_o, rays_d = rays_from_K(H, W, K, torch.as_tensor(scene.poses[ids[0]], device=device))
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    plain_q = make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))

    def kernel_vs_plain(pc, pf):
        ours = make_image_renderer(cfg)(pc, pf, rays_o, rays_d)
        plain = make_image_renderer(cfg, query_fn=plain_q)(pc, pf, rays_o, rays_d)
        for name, out in (("kernel", ours), ("plain", plain)):
            _check_maps(f"ScanNet view ({name})", rgb=out["rgb"], ins=out["ins"])
            d = out["depth"]
            if not torch.isfinite(d).all() or float(d.min()) < 0 or float(d.max()) > cfg.far * 1.0001:
                raise AssertionError(f"ScanNet view ({name}) depth map not finite in [0, far]")
        mse = float(torch.mean((ours["rgb"].double() - plain["rgb"].double()) ** 2))
        top2 = plain["ins"].topk(2, dim=-1).values
        return dict(rgb_psnr_db=float("inf") if mse == 0 else float(-10.0 * np.log10(mse)),
                    label_flip_share=float((ours["ins"].argmax(-1) != plain["ins"].argmax(-1))
                                           .float().mean()),
                    depth_max_abs_err=float((ours["depth"] - plain["depth"]).abs().max()),
                    plain_label_margin_median=float((top2[:, 0] - top2[:, 1]).median()))

    trained = kernel_vs_plain(pc, pf)
    init = kernel_vs_plain(*init_params(cfg, device))
    psnr, flip = trained["rgb_psnr_db"], trained["label_flip_share"]
    # the device time by kernel of one view, from torch.profiler, and that view's host
    # time: K7's share of the view
    view, view_s = make_image_renderer(cfg), []

    def timed_view():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view(pc, pf, rays_o, rays_d)
        torch.cuda.synchronize()
        view_s.append(time.perf_counter() - t0)
    split = launch_split(timed_view, reps=1,
                         kinds=(("k7", ("fused_pe_kernel",)), ("k5", ("fused_mlp_fwd_kernel",))))
    profiled_view_ms = view_s[-1] * 1e3

    ms = [t * 1e3 for t in res["times"]]
    out = dict(views=len(ids), H=H, W=W, crop=[cfg.crop_height, cfg.crop_width],
               chunks_per_view=chunks, ins_num=cfg.ins_num, launches=launches,
               psnr=res["psnrs"], ap=[list(a) for a in res["aps"]], ms_per_view=ms,
               rays_per_s=[H * W / (t * 1e-3) for t in ms], kernel_vs_plain=trained,
               init_weights_kernel_vs_plain=init, device_ms_by_kernel=split,
               profiled_view_ms=profiled_view_ms,
               k7_share_of_device_time=split["k7"] / split["total"],
               k7_share_of_view=split["k7"] / profiled_view_ms)
    print(f"[render scannet] {json.dumps(out)}", flush=True)
    if psnr < MIN_PSNR_DB or flip > MAX_LABEL_FLIP:
        raise AssertionError(f"ScanNet view, kernel vs plain: rgb PSNR {psnr:.2f} dB (want >= "
                             f"{MIN_PSNR_DB}), label flips {flip:.4f} (want <= {MAX_LABEL_FLIP})")
    return launches


def _check_maps(what, **maps):
    """Every map finite and in [0, 1]."""
    import torch

    for k, v in maps.items():
        v = torch.as_tensor(v)
        if not torch.isfinite(v).all() or float(v.min()) < 0 or float(v.max()) > 1:
            raise AssertionError(f"{what} {k} map not finite in [0, 1]")


def mani_phase(device):
    """The manipulation path: manipulator_eval under pallas_pe_mode = kernel (K3),
    manipulator_demo under the default mode (K1), and one manipulated view with
    deterministic draws through the kernel query and the plain PyTorch query."""
    import numpy as np
    import torch

    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.core.pipeline import make_torch_query_fn
    from dmnerf_tpu_torch.core.rays import rays_from_K
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_mani_scene, build_dmsr_scene
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.mani_eval import manipulator_demo, manipulator_eval
    from dmnerf_tpu_torch.render.manipulator import make_manipulator_renderer
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.tools.pose_gen import demo_poses, eval_poses

    H = W = 256
    n_views = 2
    scene = build_dmsr_mani_scene("translation", n_test=n_views, H=H, W=W, n_objects=4,
                                  ins_num=32, seed=SEED)
    cfg = load_config(os.path.join(REPO, "configs", "manipulation", "dmsr",
                                   "manipulation_translation", "study.txt"),
                      near=1.0, far=8.0, ins_num=scene.ins_num, target_label=1, perturb=0.0,
                      pallas_pe_mode="kernel")
    pc, pf = init_params(cfg, device)
    chunks = -(-H * W // cfg.N_test)
    trans_dicts = eval_poses(cfg)["transformations"]

    def expect(launches, name, want, what):
        for k in runtime.COUNTED:
            if launches[k] != (want if k == name else 0):
                raise AssertionError(f"{what}: {k} launched {launches[k]} times, want "
                                     f"{want if k == name else 0}")

    # manipulator_eval: K = 1 under pe_mode 'kernel'
    runtime.reset_launches()
    ev = manipulator_eval(cfg, pc, pf, scene.poses, scene.hwk, trans_dicts, None, scene.ins_rgbs,
                          gt_rgbs=scene.images, gt_labels=scene.gt_labels, device=device)
    eval_launches = dict(runtime.LAUNCHES)
    expect(eval_launches, "fused_mlp_fwd_kpe", chunks * (3 + 3 * 1) * n_views, "mani_eval")
    for img in ev["images"]:
        _check_maps("mani_eval", rgb=img)

    # manipulator_demo: K = 2 (a translation and a sin deform) under the default mode
    base = build_dmsr_scene(n_train=1, n_test=1, H=H, W=W, n_objects=4, ins_num=32, seed=SEED,
                            views=2)
    objs = [dict(base.objs[0]),
            {"obj_name": "sphere_1", "tar_id": 2, "mani_mode": "deform", "deform_func": "sin"}]
    demo_cfg = cfg.replace(pallas_pe_mode=None, views=2)
    runtime.reset_launches()
    dm = manipulator_demo(demo_cfg, pc, pf, base.hwk, demo_poses(objs, 2), None, base.ins_rgbs,
                          objs, base.view_poses, base.ins_map, device=device)
    demo_launches = dict(runtime.LAUNCHES)
    expect(demo_launches, "fused_mlp_fwd", chunks * (3 + 3 * 2) * 2, "mani_demo")
    for img in dm["images"]:
        _check_maps("mani_demo", rgb=img)

    # one manipulated view, deterministic draws: the kernel query vs the plain query
    K = torch.as_tensor(scene.K, device=device)
    pose = scene.poses[0]
    trans = np.asarray(trans_dicts[0]["transformation"], np.float32)
    rays = [rays_from_K(H, W, K, torch.as_tensor(c2w, device=device))
            for c2w in (pose, trans @ pose)]
    (oo, od), (to, td) = [(o.reshape(-1, 3), d.reshape(-1, 3)) for o, d in rays]
    args = (pc, pf, oo, od, to[None], td[None], (1,))
    run_k = make_manipulator_renderer(cfg, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ours = run_k(*args)
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3
    plain_q = make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    plain = make_manipulator_renderer(cfg, 1, query_fn=plain_q)(*args)
    for name, out in (("kernel", ours), ("plain", plain)):
        _check_maps(f"manipulated view ({name})", rgb=out["rgb"], ins=out["ins"])
    psnrs = {}
    for k in ("rgb", "tar_rgb"):
        mse = float(torch.mean((ours[k].double() - plain[k].double()) ** 2))
        psnrs[k] = float("inf") if mse == 0 else float(-10.0 * np.log10(mse))
    flip = float((ours["ins"].argmax(-1) != plain["ins"].argmax(-1)).float().mean())
    # tar_rgb, the target bundle's 64-sample coarse composite, is printed and not held to
    # the bar: its last sample's distance is 1e10, so its weight jumps with the sign of a
    # near-zero sigma, and bf16 rounding alone moves a few rays by up to 0.5
    tar_off = float(((ours["tar_rgb"] - plain["tar_rgb"]).abs().amax(-1) > 1e-2).float().mean())

    ms = [t * 1e3 for t in ev["times"]]
    demo_ms = [t * 1e3 for t in dm["times"]]
    out = dict(H=H, W=W, chunks_per_view=chunks, eval_launches=eval_launches,
               demo_launches=demo_launches, psnr=ev["psnrs"], ssim=ev["ssims"],
               ap=[list(a) for a in ev["aps"]], eval_ms_per_view=ms,
               eval_rays_per_s=[H * W / (t * 1e-3) for t in ms], demo_ms_per_frame=demo_ms,
               demo_rays_per_s=[H * W / (t * 1e-3) for t in demo_ms],
               deterministic_view_ms=det_ms,
               kernel_vs_plain=dict(rgb_psnr_db=psnrs["rgb"], label_flip_share=flip,
                                    tar_rgb_psnr_db=psnrs["tar_rgb"],
                                    tar_rgb_rays_off_1e2=tar_off))
    print(f"[mani] {json.dumps(out)}", flush=True)
    if psnrs["rgb"] < MIN_PSNR_DB or flip > MAX_LABEL_FLIP:
        raise AssertionError(f"manipulated view, kernel vs plain: rgb PSNR {psnrs['rgb']:.2f} dB "
                             f"(want >= {MIN_PSNR_DB}), label flips {flip:.4f} (want <= "
                             f"{MAX_LABEL_FLIP})")
    return eval_launches, demo_launches


MESH_GRID = 256
MESH_LEVEL_QUANTILE = 0.999


def mesh_phase(cfg, device):
    """The mesh path: the 256^3 sigma sweep (K1) against the plain sweep, then
    run_test's mesh mode at a level the sweep sets, its colour render against the
    plain query."""
    import math
    import tempfile

    import numpy as np
    import torch

    from dmnerf_tpu_torch.core.mlp import sigma_stub_params
    from dmnerf_tpu_torch.core.pipeline import make_query_fn, make_torch_query_fn
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.renderer import make_image_renderer
    from dmnerf_tpu_torch.test import init_params, run_test
    from dmnerf_tpu_torch.tools.mesh_extract import (DEFAULT_EXTENTS, build_grid,
                                                     make_sigma_query)
    from dmnerf_tpu_torch.tools.meshing import read_ply

    scene = build_dmsr_scene(n_train=1, n_test=1, H=64, W=64, n_objects=4, ins_num=32, seed=SEED)
    cfg = cfg.replace(near=1.0, far=8.0, ins_num=scene.ins_num, perturb=0.0, render=False,
                      mesh=True, mesh_grid_dim=MESH_GRID)
    pc, pf = init_params(cfg, device)
    grid = torch.from_numpy(build_grid(np.eye(4), DEFAULT_EXTENTS, MESH_GRID)).to(device)
    sweep = make_sigma_query(cfg)

    # the sweep: its launches, times and sigma against the fp32 plain sweep
    runtime.reset_launches()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    sigma = sweep(pf, grid)
    end.record()
    end.synchronize()
    sweep_host_ms = (time.perf_counter() - t0) * 1e3
    sweep_ms = start.elapsed_time(end)
    sweep_launches = dict(runtime.LAUNCHES)
    n_chunks = -(-MESH_GRID ** 3 // 65536)       # 256 at 256^3: the default chunk's launches
    for k in runtime.COUNTED:
        want = n_chunks if k == "fused_mlp_fwd" else 0
        if sweep_launches[k] != want:
            raise AssertionError(f"the {MESH_GRID}^3 sweep launched {k} {sweep_launches[k]} "
                                 f"times, want {want}")
    k1_sweep = launch_split(lambda: sweep(pf, grid), reps=1,
                            kinds=(("k1", ("fused_mlp_fwd_kernel",)),))
    plain_sigma = make_sigma_query(cfg.replace(use_pallas=False))(pf, grid)
    scale = float(plain_sigma.abs().max())
    err = float((sigma - plain_sigma).abs().max())
    if not torch.isfinite(sigma).all() or sigma.shape != (MESH_GRID ** 3,):
        raise AssertionError(f"sweep sigma not finite or of shape {tuple(sigma.shape)}")

    # one chunk: the stub's sigma against the full model's, and one launch's times
    query_fn = make_query_fn(cfg)
    stub, full = sigma_stub_params(pf), pf
    packed_stub, packed_full = query_fn.prepare(stub), query_fn.prepare(full)
    pts = grid[:65536].reshape(1024, 64, 3).contiguous()     # build_grid's axis swap strides it
    dirs = torch.zeros((1024, 3), device=device)
    with torch.no_grad():
        raw = query_fn.query(packed_stub, pts, dirs)
        full_sigma = query_fn.query(packed_full, pts, dirs)[..., 3]
        stub_err = float((raw[..., 3] - full_sigma).abs().max())
        sig_scale = float(full_sigma.abs().max())
        ref32 = _plain_fwd("kernel_t", packed_stub, pts, dirs, torch.float32)
        ms = _time_ms(lambda: query_fn.query(packed_stub, pts, dirs))
        plain_ms = _time_ms(lambda: _plain_fwd("kernel_t", packed_stub, pts, dirs, torch.float32),
                            reps=5)
        library_ms = _time_ms(lambda: library_query(packed_stub, pts, dirs))
    flops = 2.0 * query_macs(stub) * pts.shape[0] * pts.shape[1]
    nbytes = (pts.numel() * 4 + dirs.numel() * 4 + packed_stub.w_bf16.numel() * 2
              + packed_stub.b.numel() * 4 + raw.numel() * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    # ms: K1's device time a launch in the sweep (torch.profiler); call_ms: one event pair
    # around one query call, the host's enqueue included
    launch = dict(points=pts.shape[0] * pts.shape[1], max_abs_err=float((raw - ref32).abs().max()),
                  ms=k1_sweep["k1"] / n_chunks, call_ms=ms, plain_ms=plain_ms,
                  library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes", gflop=flops / 1e9,
                  mbytes=nbytes / 1e6)
    if stub_err > STUB_TOL * max(sig_scale, 1.0):
        raise AssertionError(f"mesh chunk: stub sigma max|d| {stub_err:.3e} > {STUB_TOL} * "
                             f"max({sig_scale:.3e}, 1)")

    # the level: a high quantile of the kernel sweep's occupancy (seeded weights keep
    # occupancy far below the reference's 0.45)
    voxel = (cfg.far - cfg.near) / cfg.N_importance
    occ = 1.0 - torch.exp(-torch.relu(sigma) * voxel)
    occ_plain = 1.0 - torch.exp(-torch.relu(plain_sigma) * voxel)
    level = float(np.quantile(occ.cpu().numpy(), MESH_LEVEL_QUANTILE))
    side_share = float(((occ > level) != (occ_plain > level)).float().mean())
    del plain_sigma, occ_plain, ref32

    # run_test's mesh mode at that level
    with tempfile.TemporaryDirectory() as tmp:
        mcfg = cfg.replace(basedir=tmp, expname="chip_smoke_mesh", mesh_level=level)
        runtime.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = run_test(mcfg, device, scene=scene)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        launches = dict(runtime.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not stats["faces"] or stats["path"] is None:
            raise AssertionError(f"empty iso-surface at level {level}")
        savedir = os.path.dirname(stats["path"])
        v_raw, f_raw = read_ply(os.path.join(savedir, "mesh.ply"))
        v_col, f_col = read_ply(stats["path"])
    if (len(v_raw), len(f_raw)) != (stats["verts"], stats["faces"]) or \
            (len(v_col), len(f_col)) != (stats["clean_verts"], stats["clean_faces"]):
        raise AssertionError("mesh.ply / color_mesh.ply read back with other counts than written")
    n_verts = stats["clean_verts"]
    want = n_chunks + 2 * math.ceil(n_verts / cfg.N_test)
    for k in runtime.COUNTED:
        if launches[k] != (want if k == "fused_mlp_fwd" else 0):
            raise AssertionError(f"mesh mode launched {k} {launches[k]} times, want "
                                 f"{want if k == 'fused_mlp_fwd' else 0} ({n_chunks} sweep + "
                                 f"2 x ceil({n_verts} / {cfg.N_test}) colour chunks)")

    # the vertex rays through the plain query: the labels against the kernel's
    plain_q = make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    plain = make_image_renderer(cfg.replace(near=0.01, far=15.0, perturb=0.0), query_fn=plain_q)
    plain_labels = plain(pc, pf, stats["rays_o"], stats["rays_d"])["ins"].argmax(-1).cpu().numpy()
    flip = float((plain_labels != stats["labels"]).mean())

    out = dict(grid=MESH_GRID, points=MESH_GRID ** 3, sweep_launches=sweep_launches["fused_mlp_fwd"],
               sweep_ms=sweep_ms, sweep_host_ms=sweep_host_ms, sweep_k1_device_ms=k1_sweep["k1"],
               sweep_other_device_ms=k1_sweep["other"], sigma_scale=scale,
               sigma_max_abs_err=err, level_quantile=MESH_LEVEL_QUANTILE, level=level,
               occupancy_max=float(occ.max()), other_side_share=side_share,
               stub_sigma_max_abs_err=stub_err, launch=launch, mesh_s=mesh_s,
               verts=stats["verts"], faces=stats["faces"], clean_verts=n_verts,
               clean_faces=stats["clean_faces"], host_s=stats["seconds"],
               peak_rss_gb=stats["peak_rss_gb"], peak_mem_gb=peak_gb, launches=launches,
               label_flip_share=flip)
    print(f"[mesh] level {level:.6g} (the {MESH_LEVEL_QUANTILE} quantile of the kernel sweep's "
          f"occupancy)", flush=True)
    print(f"[mesh] {json.dumps(out)}", flush=True)
    if err > KERNEL_TOL * max(scale, 1.0):
        raise AssertionError(f"sweep sigma vs fp32 plain sweep: max|d| {err:.3e} > {KERNEL_TOL} "
                             f"* max({scale:.3e}, 1)")
    if flip > MAX_LABEL_FLIP:
        raise AssertionError(f"vertex labels, kernel vs plain query: {flip:.4f} differ (want <= "
                             f"{MAX_LABEL_FLIP})")
    return launches, launch


def _script(name):
    """scripts/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fused_chunk(device):
    """The first chunk (N_test rays) of scripts/fused_render_probe_torch.py's view with
    the seeded flagship weights: the packed sigma stub (``pcs``) and fine model (``pfs``),
    the rays (``o``, ``d``, ``edr``), the coarse depths ``z_c`` and the fine depths ``z_f``
    sample_pdf draws from K8c's weights, as the fused renderer takes them."""
    import torch

    from dmnerf_tpu_torch.core.mlp import sigma_stub_params
    from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import fused_render as fr

    cfg, pc, pf, rays_o, rays_d = _script("fused_render_probe_torch").scene_view(device)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    N = cfg.N_test
    stub = sigma_stub_params(pc)
    pcs, pfs = fm.pack_params(stub, *args), fm.pack_params(pf, *args)
    o = rays_o[:N].contiguous()
    d, edr = fr.ray_table(pfs, rays_d[:N])
    z_c = z_val_sample(N, cfg.near, cfg.far, cfg.N_samples, device=device).contiguous()
    with torch.no_grad():
        w = fr.fused_render(pcs, o, d, z_c, True)
        z_mids = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
        z_f = torch.sort(torch.cat([z_c, sample_pdf(z_mids, w[..., 1:-1], cfg.N_importance)], -1),
                         -1).values.contiguous()
    return dict(cfg=cfg, stub=stub, pf=pf, pcs=pcs, pfs=pfs, o=o, d=d, edr=edr, z_c=z_c, z_f=z_f)


def fused_render_phase(device):
    """The fused render path: one 256² view through make_fused_renderer (K8c, K8f) and
    through make_image_renderer (K1) with the same weights, then K8c and K8f at the
    view's first chunk against their plain versions, timed."""
    import torch

    from dmnerf_tpu_torch.core.compositor import _weights, composite_maps
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import fused_render as fr
    from dmnerf_tpu_torch.kernels import runtime

    probe = _script("fused_render_probe_torch")
    view = probe.compare_views(device, size=256, reps=2)
    chunks = view["chunks"]
    launches = {k: 0 for k in runtime.COUNTED}
    launches.update(view["fused"]["launches"])
    want = {"fused_render_weights": chunks, "fused_render_maps": chunks}
    if view["fused"]["launches"] != want or view["k1"]["launches"] != {"fused_mlp_fwd": 2 * chunks}:
        raise AssertionError(f"fused view launched {view['fused']['launches']}, want {want}; K1 "
                             f"view {view['k1']['launches']}, want 2 x {chunks} fused_mlp_fwd")
    for k in ("rgb", "ins"):
        v = view["fused"]["maps"][k]
        if not torch.isfinite(v).all() or float(v.min()) < 0 or float(v.max()) > 1:
            raise AssertionError(f"fused view's {k} map not finite in [0, 1]")
    cmp = view["fused_vs_k1"]
    out = {k: v for k, v in probe._printable(view).items() if k not in ("k1", "fused")}
    for name in ("k1", "fused"):
        r = view[name]
        out[name] = {"ms_per_view": r["ms_per_view"], "launches": r["launches"],
                     **{k: r["profile"][k] for k in ("activities_per_chunk", "device_busy_ms",
                                                     "device_idle_share", "device_ms",
                                                     "port_kernel_ms")}}
    print(f"[fused render] view: {json.dumps(out)}", flush=True)
    if cmp["rgb_psnr_db"] < MIN_PSNR_DB or cmp["label_flip_share"] > MAX_LABEL_FLIP:
        raise AssertionError(f"fused view vs K1 view: rgb PSNR {cmp['rgb_psnr_db']:.2f} dB (want "
                             f">= {MIN_PSNR_DB}), label flips {cmp['label_flip_share']:.4f} (want "
                             f"<= {MAX_LABEL_FLIP})")

    # K8c and K8f at the view's first chunk against their plain versions, timed
    ch = fused_chunk(device)
    cfg, stub, pf, pcs, pfs = (ch[k] for k in ("cfg", "stub", "pf", "pcs", "pfs"))
    o, d, edr, z_c, z_f = (ch[k] for k in ("o", "d", "edr", "z_c", "z_f"))
    N = cfg.N_test
    results = {}
    with torch.no_grad():
        for name, params, packed, z, weights_only in (
                ("fused_render_weights", stub, pcs, z_c, True),
                ("fused_render_maps", pf, pfs, z_f, False)):
            got = fr.fused_render(packed, o, d, z, weights_only)
            torch.cuda.synchronize()
            ref32 = fr.fused_render_ref(packed, o, d, z, weights_only, torch.float32)
            ref16 = fr.fused_render_ref(packed, o, d, z, weights_only, torch.bfloat16)
            if not torch.isfinite(got).all() or got.shape != ref32.shape:
                raise AssertionError(f"{name}: output not finite or of shape {tuple(got.shape)}")
            scale = float(ref32.abs().max())
            tol = KERNEL_TOL * max(scale, 1.0)
            # The last sample's weight is T (1 - exp(-relu(sigma) 1e10 |d|)): 0 or T as
            # sigma is below or above 0, a jump of the compositing itself. Where the bf16
            # roundings of the query (the plain version's as the kernel's) move that
            # sigma across 0, the fp32 and bf16 plain versions disagree by up to T; such
            # rays are held to the bf16 plain version, every other to the fp32 one too.
            w32, w16 = (ref32, ref16) if weights_only else (
                fr.fused_render_ref(packed, o, d, z, True, dt) for dt in (torch.float32,
                                                                          torch.bfloat16))
            jump = (w32[:, -1] - w16[:, -1]).abs() > tol
            diff32 = (got - ref32).abs()
            held = diff32[~jump] if not weights_only else torch.cat(
                [diff32[:, :-1].reshape(-1), diff32[~jump, -1]])
            err32 = float(held.max()) if held.numel() else 0.0
            err16 = float((got - ref16).abs().max())
            S = z.shape[1]
            P = N * S
            # the products the pass executes: the whole table, or the trunk and sigma
            macs = query_macs(params) if not weights_only else \
                sum(params[f"trunk_{i}_w"].numel() for i in range(cfg.netdepth)) \
                + params["density_w"].numel()
            flops = 2.0 * macs * P
            layers = fr._sigma_table(packed).layers if weights_only else packed.layers
            nbytes = (o.numel() * 4 + d.numel() * 4 + z.numel() * 4 + edr.numel() * 2
                      + sum(layer.K * layer.N for layer in layers) * 2
                      + sum(layer.N for layer in layers) * 4 + got.numel() * 4)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3

            def library(packed=packed, z=z, weights_only=weights_only):
                pts = o[..., None, :] + d[..., None, :] * z[..., :, None]
                raw = library_query(packed, pts, d / torch.linalg.norm(d, dim=-1, keepdim=True))
                if weights_only:
                    return _weights(raw, z, d)
                return composite_maps(raw, z, d, keep_air=True)

            lib = library()
            lib = lib if weights_only else torch.cat([lib[0], lib[2][:, None], lib[1]], -1)
            dev = device_ms(lambda: fr._launch_render(packed, o, d, z, edr, weights_only))
            # K1 on the same products, over the points the plain path forms: the pass
            # without its point formation and compositing
            pts = (o[..., None, :] + d[..., None, :] * z[..., :, None]).contiguous()
            k1_packed = fr._sigma_table(packed) if weights_only else packed
            k1 = device_ms(lambda: fm._launch_fwd("fused_mlp_fwd", k1_packed, pts, edr, P, S))
            r = dict(rays=N, samples=S, points=P, out_scale=scale, max_abs_err=err32,
                     max_abs_err_bf16_plain=err16, last_sample_jumps=int(jump.sum()),
                     max_abs_err_all_rays=float(diff32.max()),
                     library_max_abs_err=float((lib - ref32).abs().max()),
                     ms=dev["device_ms"], **dev, k1_device_ms=k1["device_ms"],
                     call_ms=_time_ms(lambda: fr.fused_render(packed, o, d, z, weights_only)),
                     plain_ms=_time_ms(lambda: fr.fused_render_ref(packed, o, d, z, weights_only,
                                                                   torch.float32), reps=5),
                     library_ms=_time_ms(library), bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     gflop=flops / 1e9, mbytes=nbytes / 1e6, launches_per_view=chunks)
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            if not weights_only:
                # K8f under both schedules, in turns: device time, share, bits equal
                r["schedule"] = fm.SCHEDULE_NAMES[fr.MAPS_SCHEDULE]
                r.update(schedule_turns(lambda sc: fr._launch_render(packed, o, d, z, edr, False,
                                                                      sc)))
                for sname in fm.SCHEDULE_NAMES.values():
                    r[f"{sname}_share_of_bound"] = r["bound_ms"] / r[f"{sname}_ms"]
            print(f"[fused render] {name}: {json.dumps(r)}", flush=True)
            if not weights_only and not (r["bits_equal_lockstep"] and r["repeats_bit_identical"]):
                raise AssertionError(f"{name}: pipelined's bits equal to lockstep's "
                                     f"{r['bits_equal_lockstep']}, repeats "
                                     f"{r['repeats_bit_identical']}")
            if err32 > tol or err16 > tol:
                raise AssertionError(f"{name}: kernel vs fp32 plain max|d| {err32:.3e} (but "
                                     f"the last sample's jumps), vs bf16 plain {err16:.3e}; "
                                     f"want <= {KERNEL_TOL} * max({scale:.3e}, 1)")
            results[name] = r
    log = runtime.library_path("fused_render").with_suffix(".log").read_text()
    for fn, line in register_lines(log):
        if "<maps>" in fn:
            print(f"[fused render] registers {fn}: {line}", flush=True)
    runtime.reset_launches()
    return launches, results


def head_probes_phase(device):
    """The head probes K9 and K10 at their probes' shapes: the launches of the probes'
    questions (one a mode or variant), then each against its plain versions, timed."""
    from dmnerf_tpu_torch.kernels import head_probes as hpr
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.kernels.fused_mlp import SCHEDULE_NAMES

    launches = {k: 0 for k in runtime.COUNTED}
    res = {}
    for name, kernel, cases in (("head512_probe_torch", "head512", "modes"),
                                ("mfu_probe4_torch", "heads_fused", "variants")):
        probe = _script(name)
        r = probe.measure(device)
        for k, n in r["launches"].items():
            launches[k] += n
        for case, v in r[cases].items():
            print(f"[head probes] {kernel} {case}: {json.dumps(v)}", flush=True)
        print(f"[head probes] {kernel} answer: {json.dumps(r['answer'])}", flush=True)
        probe.check(r)
        want = len(r[cases])
        if r["launches"] != {kernel: want}:
            raise AssertionError(f"{name}: launched {r['launches']}, want {want} {kernel}")
        res[kernel] = r
    # K10's variants under both schedules, in turns; its answer under each
    r, by_schedule = res["heads_fused"], {sname: {} for sname in SCHEDULE_NAMES.values()}
    mfu4 = _script("mfu_probe4_torch")
    for case, launch in mfu4.launchers(device).items():
        t = schedule_turns(launch)
        v = r["variants"][case]
        v.update(t, schedule=SCHEDULE_NAMES[hpr.HEADS_FUSED_SCHEDULE])
        for sname in SCHEDULE_NAMES.values():
            v[f"{sname}_share_of_bound"] = v["bound_ms"] / t[f"{sname}_ms"]
            by_schedule[sname][case] = t[f"{sname}_ms"]
        print(f"[head probes] heads_fused {case} schedules: {json.dumps(t)}", flush=True)
        if not (t["bits_equal_lockstep"] and t["repeats_bit_identical"]):
            raise AssertionError(f"heads_fused {case}: pipelined's bits equal to lockstep's "
                                 f"{t['bits_equal_lockstep']}, repeats "
                                 f"{t['repeats_bit_identical']}")
    r["answer_by_schedule"] = {sname: mfu4.answer(ms) for sname, ms in by_schedule.items()}
    print(f"[head probes] heads_fused answer by schedule: {json.dumps(r['answer_by_schedule'])}",
          flush=True)
    return launches, res


def _entry(name, replaces, launches, by_path, res, **extra):
    return {"name": name, "route": "cuda", "source": f"dmnerf_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "launches_by_path": by_path[name],
            "max_abs_err": res["max_abs_err"], **extra,
            "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]}


def _bwd_extra(res):
    """A backward kernel's extra keys in the kernels line: its gradient error, the
    standalone call (training forward + backward) and the query as training runs it,
    beside the library's forward + backward."""
    return {k: res[k] for k in ("grad_scale", "max_rel_err", "entry_ms", "fwd_bwd_ms",
                                "library_fwd_bwd_ms", "launch_ms")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.kernels import runtime

    if torch.cuda.get_device_capability(0) != (9, 0):
        print(f"chip_smoke: want a capability 9.0 card, got {torch.cuda.get_device_capability(0)}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi_line = smi("name,power.limit")
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    reports = runtime.build()
    print(f"[build] {len(reports)} kernel(s) in {time.time() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for fn, line in register_lines(rep):
            print(f"[build] {name} {fn}: {line}", flush=True)

    device = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs", "test", "dmsr", "study.txt"), ins_num=32)
    kres = kernel_phase(cfg, device)
    kres_kpe = kernel_phase(cfg, device, "kernel")
    torch.cuda.empty_cache()
    render_launches = slice_phase(cfg, device)
    train_cfg = load_config(os.path.join(REPO, "configs", "train", "dmsr", "study.txt"),
                            ins_num=32, near=1.0, far=8.0)
    bres = bwd_kernel_phase(train_cfg, device)
    bres_kpe = bwd_kernel_phase(train_cfg, device, "kernel")
    train_launches, _, _, k11 = train_phase(device)
    torch.cuda.empty_cache()
    kpe_train_launches, _, _, _ = train_phase(device, "kernel", KPE_TRAIN_STEPS)
    torch.cuda.empty_cache()
    eval_launches, demo_launches = mani_phase(device)
    torch.cuda.empty_cache()
    kres_pe = kernel_pe_phase(cfg, device, smi_line)
    bres_pe = bwd_kernel_phase(train_cfg, device, "outside")
    torch.cuda.empty_cache()
    scannet_train_launches, scene, state, _ = train_phase(device, "outside", SCANNET_TRAIN_STEPS,
                                                          "scannet")
    torch.cuda.empty_cache()
    scannet_render_launches = render_scannet_phase(device, scene, state.params_coarse,
                                                   state.params_fine)
    del scene, state
    torch.cuda.empty_cache()
    mesh_launches, mesh_launch = mesh_phase(cfg, device)
    torch.cuda.empty_cache()
    fused_launches, fres = fused_render_phase(device)
    torch.cuda.empty_cache()
    probe_launches, pres = head_probes_phase(device)
    torch.cuda.empty_cache()
    packed_launches, _ = packed_train_phase(device, smi_line)
    torch.cuda.empty_cache()
    packed_scannet_launches, _ = packed_train_phase(device, smi_line, "outside", "scannet",
                                                    *SCANNET_PACK, timed=False)

    paths = {"render": render_launches, "train": train_launches, "train_kpe": kpe_train_launches,
             "mani_eval": eval_launches, "mani_demo": demo_launches,
             "train_scannet": scannet_train_launches, "render_scannet": scannet_render_launches,
             "mesh": mesh_launches, "render_fused": fused_launches, "probe_heads": probe_launches,
             "train_packed": packed_launches, "train_packed_scannet": packed_scannet_launches}
    by_path = {name: {path: n[name] for path, n in paths.items()} for name in runtime.COUNTED}
    for name in runtime.COUNTED:
        if sum(by_path[name].values()) == 0:
            raise AssertionError(f"{name} was never launched on the main paths")
    kernels = [
        _entry("fused_mlp_fwd", "dmnerf_tpu/kernels/fused_mlp.py:507", render_launches["fused_mlp_fwd"],
               by_path, kres["fine"], mesh_launch=mesh_launch),
        _entry("fused_mlp_bwd", "dmnerf_tpu/kernels/fused_mlp.py:520", train_launches["fused_mlp_bwd"],
               by_path, bres["fine"], **_bwd_extra(bres["fine"])),
        _entry("fused_mlp_fwd_kpe", "dmnerf_tpu/kernels/fused_mlp.py:462",
               eval_launches["fused_mlp_fwd_kpe"], by_path, kres_kpe["fine"]),
        _entry("fused_mlp_bwd_kpe", "dmnerf_tpu/kernels/fused_mlp.py:481",
               kpe_train_launches["fused_mlp_bwd_kpe"], by_path, bres_kpe["fine"],
               **_bwd_extra(bres_kpe["fine"])),
        _entry("fused_mlp_fwd_pe", "dmnerf_tpu/kernels/fused_mlp.py:471",
               scannet_render_launches["fused_mlp_fwd_pe"], by_path, kres_pe["fine"]["k5"],
               vs_k1_differing=kres_pe["fine"]["k5"]["vs_k1_differing"]),
        _entry("fused_mlp_bwd_pe", "dmnerf_tpu/kernels/fused_mlp.py:494",
               scannet_train_launches["fused_mlp_bwd_pe"], by_path, bres_pe["fine"],
               **_bwd_extra(bres_pe["fine"])),
        _entry("fused_pe", "dmnerf_tpu/kernels/fused_mlp.py:689",
               scannet_render_launches["fused_pe"], by_path, kres_pe["fine"]["k7"],
               **{k: kres_pe["fine"]["k7"][k] for k in ("call_ms", "bytes_bound_ms",
                                                         "issue_bound_ms", "share_of_bound",
                                                         "card")}),
    ]
    sched_keys = ("schedule", "lockstep_ms", "bits_equal_lockstep")
    for name in ("fused_render_weights", "fused_render_maps"):
        keys = ("call_ms", "share_of_bound") + (sched_keys if name == "fused_render_maps" else ())
        kernels.append({**_entry(name, "scripts/dev/fused_render_probe.py:142",
                                 fused_launches[name], by_path, fres[name],
                                 **{k: fres[name][k] for k in keys}),
                        "source": "dmnerf_tpu_torch/kernels/csrc/fused_render.cu"})
    # K9 by the TPU kernel's layout (mode a, head [256, 513]) and K10 by the probe's
    # (one block-diagonal output), each with its other modes beside
    for name, replaces, cases, main_case in (
            ("head512", "scripts/dev/head512_probe.py:83", "modes", "a"),
            ("heads_fused", "scripts/dev/mfu_probe4.py:79", "variants", "block_diagonal")):
        r = pres[name]
        worst = max(v["max_abs_err"] for v in r[cases].values())
        keys = sched_keys if name == "heads_fused" else ()
        kernels.append(_entry(name, replaces, probe_launches[name], by_path,
                              {**r[cases][main_case], "max_abs_err": worst},
                              **{k: r[cases][main_case][k] for k in keys},
                              **{cases: {k: {kk: v[kk] for kk in (
                                  "ms", "plain_ms", "library_ms", "bound_ms", "share_of_bound",
                                  "model_tflops", "executed_tflops", "max_abs_err",
                                  "max_abs_err_bf16_plain") + keys}
                                  for k, v in r[cases].items()},
                                 "answer": r["answer"],
                                 **{k: r[k] for k in ("answer_by_schedule",) if k in r}}))
    kernels.append(_entry("assignment", "dmnerf_tpu/objfield/hungarian.py:123",
                          train_launches["assignment"], by_path, k11,
                          **{k: k11[k] for k in ("device_us", "host_scipy_ms", "argmin_latency_us",
                                                 "step_dijkstra_iterations", "share_of_bound")}))
    print(f"[done] {time.time() - t0:.1f} s from the build on", flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
