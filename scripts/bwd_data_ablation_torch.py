"""Where the backward-data walk of the port's parameter backward (bwd_data_kernel in
dmnerf_tpu_torch/kernels/csrc/fused_mlp_bwd.cuh) spends its time, on one CUDA card:
the kernel is rebuilt with parts of its epilogue left out, and each variant's device
time is read at the flagship fine training query (configs/train/dmsr/study.txt:
3072 x 192 points, seeded random weights, K2's tables).

    python3 scripts/bwd_data_ablation_torch.py

Variants: 'full' (the kernel as it is), 'no_store' (the mover's TMA stores of the bf16
cotangents to d_pre left out; the consumers still write them into their tiles),
'no_mask' (the ReLU mask neither loaded into the tiles, nor read, nor applied),
'no_shuffle' (the bias column sums' warp shuffles left out), 'bare' (all three left
out: the products, the ring, the A-fragment conversion and the tiles' hand-offs
alone). Only 'full' computes the gradients (it is checked bit for bit against the
package's own launch); the others time the walk and nothing else. Each edit names the
source text it cuts, and the script raises when the source no longer holds it. The sources are copied and edited under build/ablation/, and
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
STORE = ("            if (rw < P && q * 64 < p.steps[s].N)\n"
         "              tma_store_2d(&p.dpre_maps[s], mtile + w * MTILE_BYTES + q * MBOX_BYTES, "
         "q * 64, rw);\n")
MASK_LOAD = ("""        if (rw < P && q * 64 < p.steps[st].N) {
          mbar_expect_tx(bar, MBOX_BYTES);
          tma_load_2d(mtile + w * MTILE_BYTES + q * MBOX_BYTES, &p.mask_maps[st], bar, q * 64, rw);
        } else {
          mbar_arrive(bar);   // no point or column of this box: nothing to read
        }
""", "        mbar_arrive(bar);\n")
MASK_READ = ("            ldmatrix_x4((lb + q * MBOX_BYTES) ^ (16 * (4 * hb)), mk[0]);\n"
             "            ldmatrix_x4((lb + q * MBOX_BYTES) ^ (16 * (4 * hb + 2)), mk[1]);\n", "")
MASK_USE = [(f"relu_mask(m{i}, u{i}, acc[4 * j{a}], acc[4 * j{b}], x{2 * i}, x{2 * i + 1});",
             f"x{2 * i} = acc[4 * j{a}], x{2 * i + 1} = acc[4 * j{b}];")
            for i, a, b in ((0, "", " + 1"), (1, " + 2", " + 3"))]
SHUFFLE = """#pragma unroll
            for (int lv = 0; lv < 3; ++lv) {
              const int n = 4 >> lv;
              const bool hi = (g >> lv) & 1;
#pragma unroll
              for (int i = 0; i < n; ++i) {
                const float send = hi ? cs[i] : cs[n + i];
                cs[i] = (hi ? cs[n + i] : cs[i]) + __shfl_xor_sync(0xffffffffu, send, 4 << lv);
              }
            }
"""


def _cut(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"fused_mlp_bwd.cuh no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    store, mask, shuffle = [(STORE, "")], [MASK_LOAD, MASK_READ] + MASK_USE, [(SHUFFLE, "")]
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
    _, plan, (stash,) = fm.query_train_fwd(packed, pts, dirs)
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
