"""Where the backward-data walk of the port's parameter backward (bwd_data_kernel in
dmnerf_tpu_torch/kernels/csrc/fused_mlp_bwd.cuh) spends its time, on one CUDA card:
the kernel is rebuilt with parts of its epilogue left out, and each variant's device
time is read at the flagship fine training query (configs/train/dmsr/study.txt:
3072 x 192 points, seeded random weights, K2's tables).

    python3 scripts/bwd_data_ablation_torch.py

Variants: 'full' (the kernel as it is), 'no_store' (the bf16 cotangent stores left
out), 'no_mask' (the ReLU-mask tile neither loaded nor applied), 'no_shuffle' (the
bias column sums' warp shuffles left out), 'bare' (all three left out: the products,
the ring and the A-fragment conversion alone). Only 'full' computes the gradients
(it is checked bit for bit against the package's own launch); the others time the
walk and nothing else. The sources are copied and edited under build/ablation/, and
each variant is compiled with nvcc as dmnerf_tpu_torch.kernels.runtime compiles the
kernels. The last line of stdout is one JSON object of bwd_data ms per variant, with
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = ("            if (v0) *reinterpret_cast<uint32_t*>(dp + r0 * st.N + col) = h0;\n"
         "            if (v1) *reinterpret_cast<uint32_t*>(dp + r1 * st.N + col) = h1;\n")
MASK_LOAD = ("            if (p0 + r < P) cp_async16(mtile + r * LDM + q * 8, "
             "src + (p0 + r) * st.N + q * 8);\n")
MASK_USE = [(f"x{i} = __bfloat162float(m.{c}) > 0.f ? acc[4 * j{o}] : 0.f;", f"x{i} = acc[4 * j{o}];")
            for i, c, o in ((0, "x", ""), (1, "y", " + 1"), (2, "x", " + 2"), (3, "y", " + 3"))]
SHUFFLE = """#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, m);
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
          }"""


def _cut(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"fused_mlp_bwd.cuh no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    store, mask, shuffle = [(STORE, "")], [(MASK_LOAD, "")] + MASK_USE, [(SHUFFLE, "")]
    return {"full": src, "no_store": _cut(src, store), "no_mask": _cut(src, mask),
            "no_shuffle": _cut(src, shuffle), "bare": _cut(src, store + mask + shuffle)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bwd_data_ablation_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.test import init_params

    csrc = runtime.CSRC
    srcs = variants((csrc / "fused_mlp_bwd.cuh").read_text())
    procs = {}
    for name, text in srcs.items():
        d = os.path.join(REPO, "build", "ablation", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        with open(os.path.join(d, "fused_mlp_bwd.cuh"), "w") as f:
            f.write(text)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "fused_mlp_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{out}")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs", "train", "dmsr", "study.txt"), ins_num=32,
                      near=1.0, far=8.0)
    _, pf = init_params(cfg, dev)
    packed = fm.pack_params(pf, cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    pts, dirs = cs._points(cfg.N_train, cfg.N_samples + cfg.N_importance, cfg.near, cfg.far, gen,
                           dev)
    with torch.no_grad():
        raw = fm.fused_query(packed, pts, dirs)
    g = (1.0 - torch.tanh(raw) ** 2).reshape(-1, packed.c4).contiguous()
    a, b = fm._kernel_inputs(packed, pts, dirs, "kernel_t")
    _, plan, stash = fm._stash_forward("kernel_t", packed, a, b, *pts.shape[:2])
    want = fm._launch_bwd("kernel_t", packed, plan, stash, g)
    table = (ctypes.c_longlong * len(plan["table"]))(*plan["table"])
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    for name in srcs:
        fn = ctypes.CDLL(os.path.join(REPO, "build", "ablation", name, "lib.so")).dmnerf_fused_mlp_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        dw, db = torch.empty_like(want[0]), torch.empty_like(want[1])
        dpre = torch.empty(plan["dpre_size"], dtype=torch.bfloat16, device=dev)
        dbpart = torch.empty((plan["bias_rows"], db.numel()), device=dev)
        dwpart = torch.empty((plan["n_chunks"], dw.numel()), device=dev)

        def call():
            err = fn(None, None, packed.w_bf16.data_ptr(), g.data_ptr(), stash.data_ptr(),
                     dpre.data_ptr(), dbpart.data_ptr(), dwpart.data_ptr(), dw.data_ptr(),
                     db.data_ptr(), ctypes.addressof(table), n_sms,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed, error {err}")
        call()
        torch.cuda.synchronize()
        if name == "full" and not (torch.equal(dw, want[0]) and torch.equal(db, want[1])):
            raise AssertionError("the unedited copy does not reproduce the package's gradients")
        res[name] = cs.launch_split(call, reps=5)["bwd_data"]
        print(f"[ablation] {name}: bwd_data {res[name]:.3f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "points": pts.shape[0] * pts.shape[1], "bwd_data_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
