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

Also the compiler's register report for each forward kernel. The last line of stdout
is one JSON object with all of it, also appended to ``--out``.

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


def _variant_lib(runtime, name, repo, define):
    """``name``'s library built from a copy of ``repo``'s sources: with the macros of
    ``define`` set (-D each, comma-separated), or, when ``define`` is None, with the
    template's refusal of an empty layer table lifted."""
    src = runtime.CSRC
    tag = re.sub(r"[^a-z0-9]+", "_", define.lower()) if define else "empty"
    dst = os.path.join(repo, "build", f"fwd_anatomy_{tag}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    if define is None:
        path = os.path.join(dst, "fused_mlp_fwd.cuh")
        text = open(path).read()
        open(path, "w").write(text.replace("n_layers < 1", "n_layers < 0"))
    so = os.path.join(dst, f"{name}.so")
    macros = [f"-D{d}" for d in (define or "").split(",") if d]
    cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *macros, "-o", so, os.path.join(dst, f"{name}.cu")]
    out = subprocess.run(cmd, check=True, capture_output=True, text=True)
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
    reports = runtime.build([*FWD.values(), "fused_pe"])
    regs = {}
    for name in [*FWD.values(), "fused_pe"]:
        fn = ""
        for line in reports[name].splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d([a-z_]+_kernel)", line)
                fn = (m.group(1) if m else "?") + ("<stash>" if "Lb1E" in line else "")
                mr = re.search(r"_kernelILi(\d+)E", line)     # K7's multires template
                fn += f"<{mr.group(1)}>" if mr else ""
            if "Used" in line and "registers" in line:
                regs[f"{name} {fn}"] = line.strip()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = dict(tag=a_.tag, repo=repo, device=torch.cuda.get_device_name(0), card=smi,
               build_s=time.time() - t0, registers=regs)
    print(f"[anatomy] {smi} build {res['build_s']:.1f} s", flush=True)
    for k, v in regs.items():
        print(f"[anatomy] {k}: {v}", flush=True)

    test_cfg = load_config(os.path.join(HERE, "configs", "test", "dmsr", "study.txt"), ins_num=32)
    cfg = load_config(os.path.join(HERE, "configs", "train", "dmsr", "study.txt"), ins_num=32,
                      near=1.0, far=8.0)
    pc, pf = init_params(cfg, device)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    if a_.k7:
        res["k7"] = k7_part(cs, fm, runtime, repo, device, pf, args)
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
