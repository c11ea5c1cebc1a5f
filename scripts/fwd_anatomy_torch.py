"""Where the forward kernels of the PyTorch/H100 port spend their time, on one CUDA
card: the question scripts/dev/fwd_anatomy.py and mfu_probe3.py asked of the TPU
kernel (prologue, trunk, heads, output), asked of dmnerf_tpu_torch's K1, K3 and K5,
and the matrix-product chain ceiling that scripts/dev/mxu_probe.py, mfu_probe*.py and
epi_probe.py measured on the TPU.

    python3 scripts/fwd_anatomy_torch.py [--repo DIR] [--tag NAME] [--out FILE]

``--repo`` is the root of the checkout whose ``dmnerf_tpu_torch`` is measured (default:
this one); the measuring code is this checkout's ``chip_smoke.py``. Run it on two
checkouts on one card, in turns (A, B, B, A), to compare two versions of the kernel.

The variants are prefixes of the packed layer table, which every version of the
forward template walks as it is given (flagship model, seeded random weights):

  prologue     no layer: the CTA builds its rows (embeddings) and stores nothing. A
               template that refuses an empty table is rebuilt for this variant from
               a copy of its sources under ``<repo>/build/`` that accepts one;
  trunk        the D trunk layers;
  heads        the trunk, sigma and the fused head;
  full         the whole table (the render path's kernel);
  full_stash   the training forward, which also writes the backward's stash
               (``stash_ms``: the call training makes, ``_stash_forward``, with its plan
               and buffer; ``stash_kernel_ms``: the launch alone into a buffer made once).

Each is timed (CUDA-event median of 10 launches) at the fine training query (3072 x
192 points), for K1 ('kernel_t'), K3 ('kernel') and K5 ('outside', over K7's
embedding). At the render chunk (2048 x 192 fine, full model; 2048 x 64 coarse, sigma
stub; K3 also the rgb stub) and the training queries (3072 x 192 and 3072 x 64, full
model) it times the full kernel (``ms``: one event pair around one launch, the host's work
included; ``device_ms``: ``chip_smoke.device_ms``, 50 back-to-back launches), the
training forward (not for the stubs, which never train) and the bf16 torch.addmm chain
over the same packed layers (the library yardstick, used nowhere in the port), with
TFLOP/s and the share of the operations bound (executed matrix FLOPs over 989 TFLOP/s),
and at the fine render chunk the digest of the kernel's output (``chip_smoke.digest``).

The chain probe is 8 plain [W, W] layers of the flagship (ReLU into the next layer) over
the fine render chunk: the practical ceiling of the template's products. Where the
template has the compile-time switch DMNERF_FWD_NO_EPILOGUE, the same chain is also
built without its epilogues (products only).

Also the compiler's register report for each forward kernel, and each kernel's wgmma
(HGMMA) and wgmma waits (WARPGROUP.DEPBAR) in its SASS (``cuobjdump -sass``): a wait for
every product means ptxas serialized them. The last line of stdout is one JSON object
with all of it, also appended to ``--out``.

With ``--k7`` it times K7 (the point embedding of pe_mode 'outside') instead, at the
render chunk (2048 x 192 fine, 2048 x 64 coarse) and the training queries (3072 x 192,
3072 x 64), points between ScanNet's near 0 and far 9.5: its device time from
back-to-back launches (``chip_smoke.device_ms``), the wrapper's per-call time
(``call_ms``, one event pair around one ``pe_points`` call, the host's work included),
its bytes and issue bounds (``chip_smoke.k7_bounds``, with the fast path of sincosf
counted in SASS) and the digest of its output; at the fine render chunk also the
compute-only and store-only builds where the source has their switches
(DMNERF_PE_NO_STORE, DMNERF_PE_STORE_ONLY); and the digests of K1, K3 and K5 at the
fine render chunk, which a change of K7 alone leaves as they were.

With ``--split SCHEDULES`` (comma-separated: ``lockstep``, ``pipelined``) it splits the
time of K8f (the fused render's maps pass, at phase 13's fine render chunk, 2048 x 192)
and K10 (the fused head probe, block-diagonal output, at its 589,824 points) instead,
under each schedule of the consumers' products. It builds the sources with
DMNERF_FWD_STAMPS, under which every consumer warp sums the clock cycles of its walk
waiting for a weight box (ring starvation), waiting for its products after each chunk
(their pace) and at a layer's end (the drain), in its epilogues, waiting for the
embedding warps (hand-offs), and every embedding warp those
of building a tile's embeddings, waiting for the consumers and compositing; each part is
printed as a share of the walk and in microseconds a tile (the walk's cycles over the
launch's device time give the clock). Beside the split: the device time of the plain
build and of the stamped one (the stamps' cost: their sums push the consumers past their
registers, so read their shares, not their times), and the ablations, each a build that
leaves out a part of the walk: DMNERF_FWD_NO_EPILOGUE (the epilogues), DMNERF_FWD_NO_BUILD
(the embedding warps' tiles: points and sincosf, or K10's edT), DMNERF_FWD_NO_COMPOSITE
(K8f's compositing), and their combinations.

In its default mode the script also times K8c and K8f at chip_smoke.py phase 13's render
chunk and K9 / K10 at their probes' shapes under the checkout's path schedules, each
with the digest of its output (``probes``), and K1 and K9 built with DMNERF_FWD_SCHED=1
(their products pipelined, variants no path runs) in turns against the checkout's own
builds, with each digest (``pipelined_variants``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = {"kernel_t": "fused_mlp_fwd", "kernel": "fused_mlp_fwd_kpe", "outside": "fused_mlp_fwd_pe"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wgmma_counts(cs, runtime, so) -> dict:
    """For each kernel of the library ``so``: its HGMMA instructions (wgmma) and its
    WARPGROUP.DEPBAR waits in the SASS (``cuobjdump -sass``). As many waits as products
    means that ptxas serialized them, each waiting for the one before."""
    cuobjdump = os.path.join(os.path.dirname(runtime._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = cs._kernel_label(m.group(1))
            counts[fn] = {"HGMMA": 0, "DEPBAR": 0}
        elif fn is not None:
            counts[fn]["HGMMA"] += "HGMMA" in line
            counts[fn]["DEPBAR"] += "WARPGROUP.DEPBAR" in line
    return {k: v for k, v in counts.items() if v["HGMMA"]}


def _variant_lib(runtime, name, repo, define):
    """``name``'s library built from a copy of ``repo``'s sources: with the macros of
    ``define`` set (-D each, comma-separated), or, when ``define`` is None, with the
    template's refusal of an empty layer table lifted."""
    src = runtime.CSRC
    tag = re.sub(r"[^a-z0-9]+", "_", define.lower()) if define else "empty"
    dst = os.path.join(repo, "build", f"fwd_anatomy_{name}_{tag}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    if define is None:
        path = os.path.join(dst, "fused_mlp_fwd.cuh")
        text = open(path).read()
        open(path, "w").write(text.replace("n_layers < 1", "n_layers < 0"))
    so = os.path.join(dst, f"{name}.so")
    macros = [f"-D{d}" for d in (define or "").split(",") if d]
    cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *macros, "-o", so, os.path.join(dst, f"{name}.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {' '.join(macros)} {name}.cu exited {out.returncode}:\n"
                           f"{out.stdout}{out.stderr}")
    with open(so + ".log", "w") as f:      # the compiler's register report
        f.write(out.stdout + out.stderr)
    return ctypes.CDLL(so)


K7_SHAPES = (("render_fine", 2048, 192), ("render_coarse", 2048, 64), ("train_fine", 3072, 192),
             ("train_coarse", 3072, 64))
# the compile-time switches of csrc/fused_pe.cu that split K7's time
K7_SPLIT = (("compute_only", "DMNERF_PE_NO_STORE"), ("store_only", "DMNERF_PE_STORE_ONLY"))


def _k7_launcher(runtime, fm, multires, x, e):
    """A function of no arguments that launches the checkout's K7 once on x into e, its
    library function resolved once: the checkout's ``_pe_launcher`` where it has one,
    else the C entry of the earlier kernel, (x, e, P, multires, width, stream)."""
    import torch

    if hasattr(fm, "_pe_launcher"):
        return fm._pe_launcher(x, e, multires)
    fn = runtime.load("fused_pe").dmnerf_fused_pe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (x.data_ptr(), e.data_ptr(), x.shape[0], multires, e.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"fused_pe launch failed: cudaError {err}")
    return launch


def _k7_variant_ms(cs, fm, runtime, lib, multires, x, e):
    """Device ms of the K7 library ``lib`` (a ``_variant_lib`` build of a split switch),
    launched on x into e."""
    keep = runtime._LOADED.get("fused_pe")
    runtime._LOADED["fused_pe"] = lib
    fm._PE_BLOCKS_PER_SM.clear()    # the variant's own occupancy
    try:
        return cs.device_ms(_k7_launcher(runtime, fm, multires, x, e))["device_ms"]
    finally:
        runtime._LOADED["fused_pe"] = keep
        fm._PE_BLOCKS_PER_SM.clear()


def k7_part(cs, fm, runtime, repo, device, pf, args):
    """K7's times, bounds and digests (see the module's docstring), and the forward
    kernels' digests at the fine render chunk."""
    import torch

    sincos = cs.sincosf_instructions(os.path.join(repo, "build", "sincos_probe"))
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    sm_mhz = float(cs.smi("clocks.max.sm").split()[0])
    res = dict(sincosf_sass=sincos, n_sms=n_sms, sm_max_mhz=sm_mhz)
    print(f"[anatomy k7] sincosf fast path {json.dumps(sincos)}, {n_sms} SMs at {sm_mhz} MHz",
          flush=True)
    packed = fm.pack_params(pf, *args)
    src = open(runtime.CSRC / "fused_pe.cu").read()
    defines = [d for _, d in K7_SPLIT if d in src]
    with concurrent.futures.ThreadPoolExecutor(len(defines) or 1) as pool:   # nvcc in parallel
        libs = dict(zip(defines, pool.map(
            lambda d: _variant_lib(runtime, "fused_pe", repo, d), defines)))
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    for shape, N, S in K7_SHAPES:
        pts, _ = cs._points(N, S, 0.0, 9.5, gen, device)
        x = pts.reshape(-1, 3).contiguous()
        P = x.shape[0]
        e = torch.empty((P, packed.ep), dtype=torch.bfloat16, device=device)
        r = dict(points=P, **cs.device_ms(_k7_launcher(runtime, fm, packed.multires, x, e)),
                 call_ms=cs._time_ms(lambda: fm.pe_points(packed, x), reps=20),
                 **cs.k7_bounds(P, packed.multires, packed.ep, sincos["per_sincosf"], n_sms,
                                sm_mhz))
        torch.cuda.synchronize()
        r["digest"] = cs.digest(e)
        if not torch.equal(e, fm.pe_points(packed, x)):
            raise AssertionError(f"{shape}: K7's launcher and pe_points disagree")
        r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
        r["fill_ms"] = cs.device_ms(lambda: e.fill_(0))["device_ms"]   # the write floor
        if shape == "render_fine":
            for vname, define in K7_SPLIT:
                if define in libs:
                    r[vname + "_ms"] = _k7_variant_ms(cs, fm, runtime, libs[define],
                                                      packed.multires, x, e)
        print(f"[anatomy k7] {shape}: {json.dumps(r)}", flush=True)
        res[shape] = r
        del e, x, pts

    gen = torch.Generator().manual_seed(cs.SEED + 3)
    pts, dirs = cs._points(2048, 192, 1.0, 8.0, gen, device)
    with torch.no_grad():
        res["fwd_digests"] = {mode: cs.digest(fm.fused_query(packed, pts, dirs, mode))
                              for mode in FWD}
    print(f"[anatomy k7] forward digests, fine render chunk: {json.dumps(res['fwd_digests'])}",
          flush=True)
    return res


# csrc/fused_mlp_fwd.cuh Stamp, in order
STAMPS = ("walk", "full", "pace", "drain", "epi", "handoff", "tiles", "e_walk", "e_build",
          "e_wait", "e_cmp", "e_cmpwait", "e_tiles", "warps", "e_warps")
# the measurement builds that leave out a part of the walk: the epilogues (the compositing
# hand-offs kept), the embedding warps' tiles (points, sincosf; edT), the compositing
NO_EPI, NO_BUILD, NO_CMP = "DMNERF_FWD_NO_EPILOGUE", "DMNERF_FWD_NO_BUILD", "DMNERF_FWD_NO_COMPOSITE"
ABLATIONS = {"k8f": {"no_epilogue": NO_EPI, "no_build": NO_BUILD, "no_composite": NO_CMP,
                     "no_build_composite": f"{NO_BUILD},{NO_CMP}",
                     "products_only": f"{NO_EPI},{NO_BUILD},{NO_CMP}"},
             "k10": {"no_epilogue": NO_EPI, "no_build": NO_BUILD,
                     "products_only": f"{NO_EPI},{NO_BUILD}"}}


def _stamps(lib, launch, reps=10):
    """The stamps of ``reps`` launches of a DMNERF_FWD_STAMPS build, summed."""
    vals = (ctypes.c_ulonglong * len(STAMPS))()
    fn = lib.dmnerf_fwd_stamps
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    launch()
    if fn(None, 1):
        raise RuntimeError("dmnerf_fwd_stamps failed")
    for _ in range(reps):
        launch()
    if fn(ctypes.addressof(vals), 1):
        raise RuntimeError("dmnerf_fwd_stamps failed")
    return dict(zip(STAMPS, (int(v) for v in vals)))


def _split(st, device_ms):
    """The walk's parts as shares and microseconds a tile (see the docstring)."""
    warps, e_warps = st["warps"], st["e_warps"]     # warps a launch x launches
    walk = st["walk"] / warps                       # cycles a consumer warp a launch
    tiles = st["tiles"] / warps                     # tiles a consumer warp (a block) a launch
    mhz = walk / (device_ms * 1e3)                  # cycles a microsecond
    parts = ("full", "pace", "drain", "epi", "handoff")
    c = {k: st[k] / warps for k in parts}
    c["issue_rest"] = walk - sum(c.values())
    e = {k: st[k] / max(e_warps, 1) for k in ("e_build", "e_wait", "e_cmp", "e_cmpwait")}
    e["e_cmp"] -= e["e_cmpwait"]
    e["e_rest"] = st["e_walk"] / max(e_warps, 1) - sum(e.values())
    return dict(tiles_per_block=tiles, implied_mhz=mhz, walk_us_per_tile=walk / tiles / mhz,
                consumer_share={k: v / walk for k, v in c.items()},
                consumer_us_per_tile={k: v / tiles / mhz for k, v in c.items()},
                embedding_us_per_tile={k: v / tiles / mhz for k, v in e.items()})


def split_part(cs, runtime, repo, device, schedules):
    """K8f's and K10's walks split by the stamps, under each of ``schedules``."""
    import torch

    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import fused_render as fr
    from dmnerf_tpu_torch.kernels import head_probes as hpr

    by_name = {name: sc for sc, name in fm.SCHEDULE_NAMES.items()}
    variants = [("fused_render", "DMNERF_FWD_STAMPS"), ("heads_fused", "DMNERF_FWD_STAMPS")]
    variants += [("fused_render", d) for d in ABLATIONS["k8f"].values()]
    variants += [("heads_fused", d) for d in ABLATIONS["k10"].values()]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:   # nvcc in parallel
        libs = dict(zip(variants, pool.map(lambda v: _variant_lib(runtime, v[0], repo, v[1]), variants)))
    res = {"registers": {}}
    for (name, define), lib in libs.items():
        for fn, line in cs.register_lines(open(lib._name + ".log").read()):
            res["registers"].setdefault(f"{name} {define} {fn}", []).append(line)
    ch = cs.fused_chunk(device)
    k8f = (ch["pfs"], ch["o"], ch["d"], ch["z_f"], ch["edr"], False)
    mfu4 = cs._script("mfu_probe4_torch")
    h_args = mfu4.inputs(mfu4.P, device)
    ops = hpr.heads_fused_operands(*h_args[2:])
    kernels = {"k8f": ("fused_render", lambda sc: fr._launch_render(*k8f, schedule=sc)),
               "k10": ("heads_fused", lambda sc: hpr._launch_probe("heads_fused", ops, h_args[0],
                                                                   h_args[1], sc))}

    def with_lib(name, lib, fn):
        keep = runtime._LOADED.get(name)
        runtime._LOADED[name] = lib
        try:
            return fn()
        finally:
            runtime._LOADED[name] = keep

    ref = {k: launch(fm.LOCKSTEP) for k, (_, launch) in kernels.items()}   # lockstep's bits
    for sname in schedules:
        sc = by_name[sname]
        for kname, (lib_name, launch) in kernels.items():
            r = dict(device_ms=cs.device_ms(lambda: launch(sc))["device_ms"],
                     bits_equal_lockstep=bool(torch.equal(launch(sc), ref[kname])))
            stamped = libs[(lib_name, "DMNERF_FWD_STAMPS")]
            r["stamped_device_ms"] = with_lib(lib_name, stamped, lambda: cs.device_ms(
                lambda: launch(sc))["device_ms"])
            r["stamps"] = with_lib(lib_name, stamped, lambda: _stamps(stamped, lambda: launch(sc)))
            r.update(_split(r["stamps"], r["stamped_device_ms"]))
            torch.cuda.synchronize()
            print(f"[anatomy split] {kname} {sname}: {json.dumps(r)}", flush=True)
            # the same launch built without parts of its work (the outputs are not kept)
            r["ablation_ms"] = {}
            for aname, define in ABLATIONS[kname].items():
                r["ablation_ms"][aname] = with_lib(lib_name, libs[(lib_name, define)],
                                                   lambda: cs.device_ms(lambda: launch(sc))[
                                                       "device_ms"])
                torch.cuda.synchronize()
            print(f"[anatomy split] {kname} {sname} ablations: device_ms {r['device_ms']:.4f}, "
                  f"{json.dumps(r['ablation_ms'])}", flush=True)
            res[f"{kname}/{sname}"] = r
    return res


def pipelined_variants_part(cs, fm, runtime, repo, device, pf, args, shapes):
    """K1 and K9, whose paths run lockstep, built with DMNERF_FWD_SCHED=1 (their products
    pipelined; variants no path runs) against the checkout's builds, in turns (lockstep,
    pipelined, pipelined, lockstep): K1 at the fine render chunk and the fine training
    query, K9 in its four modes at its probe's shape, with each build's digest."""
    import torch

    from dmnerf_tpu_torch.kernels import head_probes as hpr

    h512 = cs._script("head512_probe_torch")
    names = (FWD["kernel_t"], "head512")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:   # nvcc in parallel
        variants = dict(zip(names, pool.map(lambda n: _variant_lib(
            runtime, n, repo, f"DMNERF_FWD_SCHED={fm.PIPELINED}"), names)))
    packed = fm.pack_params(pf, *args)
    cases = [(f"k1_{shape}", FWD["kernel_t"], shape) for shape in ("render_fine", "train_fine")]
    cases += [(f"k9_{mode}", "head512", mode) for mode in hpr.H512_MODES]
    res = {}
    for case, lib_name, which in cases:
        if lib_name == "head512":
            x, ws, wd = h512.inputs(which, h512.P, device)
            ops = hpr.head512_operands(which, ws, wd)
            launch = lambda: hpr._launch_probe("head512", ops, x, None)   # noqa: E731
        else:
            pts, dirs = shapes[which][1]
            a, b, P, S = _inputs(fm, packed, pts, dirs, "kernel_t")
            launch = lambda: fm._launch_fwd(lib_name, packed, a, b, P, S)   # noqa: E731
        libs = {fm.LOCKSTEP: runtime.load(lib_name), fm.PIPELINED: variants[lib_name]}
        order = [fm.LOCKSTEP, fm.PIPELINED]
        r = {"turns_ms": {fm.SCHEDULE_NAMES[sc]: [] for sc in order}, "digest": {}}
        for sc in order + order[::-1]:
            runtime._LOADED[lib_name] = libs[sc]
            try:
                r["turns_ms"][fm.SCHEDULE_NAMES[sc]].append(cs.device_ms(launch)["device_ms"])
                r["digest"][fm.SCHEDULE_NAMES[sc]] = cs.digest(launch())
            finally:
                runtime._LOADED[lib_name] = libs[fm.LOCKSTEP]
        r["ms"] = {k: sum(v) / len(v) for k, v in r["turns_ms"].items()}
        r["bits_equal"] = len(set(r["digest"].values())) == 1
        torch.cuda.synchronize()
        print(f"[anatomy pipelined variants] {case}: {json.dumps(r)}", flush=True)
        res[case] = r
        launch = None
        torch.cuda.empty_cache()
    return res


def probes_part(cs, device):
    """K8c and K8f at phase 13's render chunk (through ``fused_render``) and K9 (its four
    modes) and K10 (both variants) at their probes' shapes (one launch over operands
    built once, ``_launch_probe``), each under the checkout's path schedule: device ms and
    the digest of the output. Those calls take the same arguments on the parent of the
    consumer schedules, so a run with --repo on that parent measures it alike."""
    import torch

    from dmnerf_tpu_torch.kernels import fused_render as fr
    from dmnerf_tpu_torch.kernels import head_probes as hpr

    res = {}
    ch = cs.fused_chunk(device)
    table = (ch["d"], ch["edr"])
    for name, packed, z, weights_only in (("k8c", ch["pcs"], ch["z_c"], True),
                                          ("k8f", ch["pfs"], ch["z_f"], False)):
        call = lambda: fr.fused_render(packed, ch["o"], ch["d"], z, weights_only, table)  # noqa: E731
        with torch.no_grad():
            res[name] = dict(device_ms=cs.device_ms(call)["device_ms"], digest=cs.digest(call()))
    h512, mfu4 = cs._script("head512_probe_torch"), cs._script("mfu_probe4_torch")
    for mode in hpr.H512_MODES:
        x, ws, wd = h512.inputs(mode, h512.P, device)
        ops = hpr.head512_operands(mode, ws, wd)
        call = lambda: hpr._launch_probe("head512", ops, x, None)   # noqa: E731
        res[f"k9_{mode}"] = dict(device_ms=cs.device_ms(call)["device_ms"], digest=cs.digest(call()))
        del x, ws, wd, ops
    args = mfu4.inputs(mfu4.P, device)
    for variant, split in mfu4.VARIANTS.items():
        ops = hpr.heads_fused_operands(*args[2:], split=split)
        call = lambda: hpr._launch_probe("heads_fused", ops, args[0], args[1])   # noqa: E731
        res[f"k10_{variant}"] = dict(device_ms=cs.device_ms(call)["device_ms"],
                                     digest=cs.digest(call()))
    torch.cuda.synchronize()
    print(f"[anatomy probes] {json.dumps(res)}", flush=True)
    return res


def _inputs(fm, packed, pts, dirs, mode):
    """(a, b, P, S): the launch inputs of ``mode``'s forward kernel."""
    N, S, _ = pts.shape
    a, b = fm._kernel_inputs(packed, pts, dirs, mode)
    return (a, b, N * S, S) if mode == "kernel_t" else (a, b, N * S, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--k7", action="store_true", help="time K7 only (see the docstring)")
    ap.add_argument("--split", default="", help="split K8f's and K10's walks under these "
                    "schedules (comma-separated: lockstep, pipelined; see the docstring)")
    a_ = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fwd_anatomy_torch: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.abspath(a_.repo)
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.core.mlp import rgb_stub_params, sigma_stub_params
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.test import init_params

    t0 = time.time()
    names = ["fused_render", "heads_fused"] if a_.split else [*FWD.values(), "fused_pe"]
    reports = runtime.build(names)
    regs = {}
    for name in names:
        for fn, line in cs.register_lines(reports[name]):
            regs.setdefault(f"{name} {fn}", []).append(line)
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = dict(tag=a_.tag, repo=repo, device=torch.cuda.get_device_name(0), card=smi,
               build_s=time.time() - t0, registers=regs,
               wgmma={name: wgmma_counts(cs, runtime, runtime.library_path(name))
                      for name in names})
    print(f"[anatomy] {smi} build {res['build_s']:.1f} s", flush=True)
    for k, v in regs.items():
        print(f"[anatomy] {k}: {v}", flush=True)
    for name, counts in res["wgmma"].items():
        print(f"[anatomy] {name} wgmma and waits in SASS: {json.dumps(counts)}", flush=True)

    test_cfg = load_config(os.path.join(HERE, "configs", "test", "dmsr", "study.txt"), ins_num=32)
    cfg = load_config(os.path.join(HERE, "configs", "train", "dmsr", "study.txt"), ins_num=32,
                      near=1.0, far=8.0)
    pc, pf = init_params(cfg, device)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    if a_.k7:
        res["k7"] = k7_part(cs, fm, runtime, repo, device, pf, args)
        return _emit(res, a_.out)
    if a_.split:
        res["split"] = split_part(cs, runtime, repo, device, a_.split.split(","))
        return _emit(res, a_.out)
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    S_f, S_c = cfg.N_samples + cfg.N_importance, cfg.N_samples
    shapes = {
        "render_fine": (pf, cs._points(test_cfg.N_test, S_f, 1.0, 8.0, gen, device)),
        "render_coarse_stub": (sigma_stub_params(pc), cs._points(test_cfg.N_test, S_c, 1.0, 8.0,
                                                                 gen, device)),
        "render_fine_rgb_stub": (rgb_stub_params(pf), None),
        "train_fine": (pf, cs._points(cfg.N_train, S_f, 1.0, 8.0, gen, device)),
        "train_coarse": (pc, cs._points(cfg.N_train, S_c, 1.0, 8.0, gen, device)),
    }
    shapes["render_fine_rgb_stub"] = (shapes["render_fine_rgb_stub"][0], shapes["render_fine"][1])
    D = cfg.netdepth
    empty_libs = {}

    def launch(mode, packed, a, b, P, S, n_layers=None):
        pk = packed if n_layers is None else dataclasses.replace(packed,
                                                                 layers=packed.layers[:n_layers])
        return fm._launch_fwd(FWD[mode], pk, a, b, P, S)

    for mode in ("kernel_t", "kernel", "outside"):
        for shape, (params, (pts, dirs)) in shapes.items():
            if shape == "render_fine_rgb_stub" and mode != "kernel":
                continue
            packed = fm.pack_params(params, *args)
            a, b, P, S = _inputs(fm, packed, pts, dirs, mode)
            flops = 2.0 * cs.query_macs(params) * P
            bound = flops / cs.PEAK_BF16_FLOPS * 1e3
            if mode == "outside":
                lib = lambda: cs.library_chain(packed, a, b)  # noqa: E731
            else:
                lib = lambda: cs.library_query(packed, pts, dirs, mode)  # noqa: E731
            r = dict(points=P, bound_ms=bound,
                     ms=cs._time_ms(lambda: launch(mode, packed, a, b, P, S)),
                     device_ms=cs.device_ms(lambda: launch(mode, packed, a, b, P, S))["device_ms"],
                     library_ms=cs._time_ms(lib))
            if shape == "render_fine":
                r["digest"] = cs.digest(launch(mode, packed, a, b, P, S))
            if "stub" not in shape:   # the backward, whose stash this is, takes no stub
                r["stash_ms"] = cs._time_ms(lambda: fm._stash_forward(mode, packed, a, b,
                                                                      P // S, S), reps=5)
                plan = fm._bwd_plan(packed, P // S, S, torch.cuda.get_device_properties(
                    device).multi_processor_count, fm._ROWS[mode])
                stash = torch.empty(plan["stash_size"], dtype=torch.bfloat16, device=device)
                r["stash_kernel_ms"] = cs._time_ms(lambda: fm._launch_fwd(
                    FWD[mode], packed, a, b, P, S, stash, plan["fwd_stash"]))
                del stash
            r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
            r["share_of_bound"] = bound / r["ms"]
            if shape == "train_fine":
                variants = {"prologue": 0, "trunk": D, "heads": D + 2}
                for vname, n in variants.items():
                    if n == 0:
                        try:
                            launch(mode, packed, a, b, P, S, 0)
                            torch.cuda.synchronize()
                        except RuntimeError:
                            name = FWD[mode]
                            if name not in empty_libs:
                                empty_libs[name] = _variant_lib(runtime, name, repo, None)
                            runtime._LOADED[name], keep = empty_libs[name], runtime._LOADED[name]
                            try:
                                r[vname + "_ms"] = cs._time_ms(
                                    lambda: launch(mode, packed, a, b, P, S, 0))
                            finally:
                                runtime._LOADED[name] = keep
                            continue
                    r[vname + "_ms"] = cs._time_ms(lambda: launch(mode, packed, a, b, P, S, n))
                r["full_ms"], r["full_stash_ms"] = r["ms"], r["stash_kernel_ms"]
            print(f"[anatomy] {mode} {shape}: {json.dumps(r)}", flush=True)
            res[f"{mode}/{shape}"] = r
            del a, b
            torch.cuda.empty_cache()

    # the chain probe: 8 plain [W, W] layers of the flagship over the fine render chunk
    packed = fm.pack_params(pf, *args)
    plain = [layer for layer in packed.layers if layer.kind == "plain"]
    chain = dataclasses.replace(packed, layers=tuple((plain * 8)[:8]))
    pts, dirs = shapes["render_fine"][1]
    a, b, P, S = _inputs(fm, packed, pts, dirs, "outside")
    flops = 2.0 * 8 * packed.width ** 2 * P
    probe = dict(points=P, layers=8, bound_ms=flops / cs.PEAK_BF16_FLOPS * 1e3,
                 ms=cs._time_ms(lambda: fm._launch_fwd(FWD["outside"], chain, a, b, P, S)))
    probe["tflops"] = flops / (probe["ms"] * 1e-3) / 1e12
    header = open(runtime.CSRC / "fused_mlp_fwd.cuh").read()
    if "DMNERF_FWD_NO_EPILOGUE" in header:
        name = FWD["outside"]
        keep = runtime._LOADED.get(name)
        runtime._LOADED[name] = _variant_lib(runtime, name, repo, "DMNERF_FWD_NO_EPILOGUE")
        try:
            probe["no_epilogue_ms"] = cs._time_ms(
                lambda: fm._launch_fwd(name, chain, a, b, P, S))
        finally:
            runtime._LOADED[name] = keep
        probe["no_epilogue_tflops"] = flops / (probe["no_epilogue_ms"] * 1e-3) / 1e12
    print(f"[anatomy] chain probe: {json.dumps(probe)}", flush=True)
    res["chain_probe"] = probe
    del a, b
    torch.cuda.empty_cache()
    res["probes"] = probes_part(cs, device)
    if "DMNERF_FWD_SCHED" in header:
        res["pipelined_variants"] = pipelined_variants_part(cs, fm, runtime, repo, device, pf,
                                                            args, shapes)
    return _emit(res, a_.out)


def _emit(res, out) -> int:
    """Print ``res`` as the last line of stdout and append it to ``out`` if given."""
    line = json.dumps(res)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
