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
model) it times the full kernel, the training forward (not for the stubs, which never
train) and the bf16 torch.addmm chain
over the same packed layers (the library yardstick, used nowhere in the port), with
TFLOP/s and the share of the operations bound (executed matrix FLOPs over 989 TFLOP/s).

The chain probe is 8 plain [W, W] layers of the flagship (ReLU into the next layer) over
the fine render chunk: the practical ceiling of the template's products. Where the
template has the compile-time switch DMNERF_FWD_NO_EPILOGUE, the same chain is also
built without its epilogues (products only).

Also the compiler's register report for each forward kernel. The last line of stdout
is one JSON object with all of it, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
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
    """``name``'s library built from a copy of ``repo``'s sources: with ``define`` set
    (-D), or, when ``define`` is None, with the template's refusal of an empty layer
    table lifted."""
    src = runtime.CSRC
    tag = "noepi" if define else "empty"
    dst = os.path.join(repo, "build", f"fwd_anatomy_{tag}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    if define is None:
        path = os.path.join(dst, "fused_mlp_fwd.cuh")
        text = open(path).read()
        open(path, "w").write(text.replace("n_layers < 1", "n_layers < 0"))
    so = os.path.join(dst, f"{name}.so")
    cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, *([f"-D{define}"] if define else []), "-o", so,
           os.path.join(dst, f"{name}.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(so)


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
    for name in FWD.values():
        fn = ""
        for line in reports[name].splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d([a-z_]+_kernel)", line)
                fn = (m.group(1) if m else "?") + ("<stash>" if "Lb1E" in line else "")
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
                     library_ms=cs._time_ms(lib))
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

    line = json.dumps(res)
    if a_.out:
        os.makedirs(os.path.dirname(os.path.abspath(a_.out)), exist_ok=True)
        with open(a_.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
