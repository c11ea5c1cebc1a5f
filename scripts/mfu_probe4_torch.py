"""The fused-head probe on the port: K10 (``kernels/head_probes.py`` ``heads_fused``) in
its two variants on the card. The question of scripts/dev/mfu_probe4.py, asked of the
port's forward template: its output layer is one block-diagonal product (``out`` in
``pack_params``, [2H, 4 + C] with zero blocks); are two products (rgb [H, 3], ins [H, C]),
the form the JAX package landed, cheaper?

    python3 scripts/mfu_probe4_torch.py [--reps 5] [--out FILE]

At the probe's P = 589,824 points (scripts/dev/mfu_probe3.py:37) with its inputs (h
[P, 256] and edT [27, P] normals in bf16) and the operands of seeded flagship parameters
(ins_num 32) through ``heads_operands`` (the port's ``_pack``), for the block-diagonal
output and the split one:

  * ms: the launch's device time, ``chip_smoke.device_ms`` (50 back-to-back launches, the
    median of ``--reps`` runs);
  * TFLOP/s on model FLOPs (the probe's count: M1 [256, 257], Wrh2 [27, 128] and M2
    [256, 36] dense, 92.6 GFLOP) and on executed FLOPs (the instructions: sigma n16, the
    head's ed chunk of 64 and h's 256 at n256, the output n64 over 256 or n16 + n64 over
    128 each), and the share of the bound (model FLOPs over 989 TFLOP/s or bytes over
    3.35 TB/s, the larger: the bytes, 336 MB);
  * plain_ms: ``heads_fused_ref`` in fp32 (CUDA events, median of 5); library_ms: the bf16
    torch.addmm chain over the same blocks (a yardstick the port never calls);
  * max|Δ| against the fp32 plain version, the bf16 one (the same roundings) and the bf16
    one with exact sums, and PyTorch's own order floor (``head_probes.compare``), and
    whether two launches are bit-identical.

Then the answer: split against one block-diagonal product, in microseconds and as a share
of the block-diagonal time. The launches run K10's path schedule
(``head_probes.HEADS_FUSED_SCHEDULE``, pipelined products); ``launchers`` gives
chip_smoke.py phase 14 a launch under either schedule. On this card the kernel is bound by
the bytes of h, which the products sit under. Needs a card of capability 9.0. The last line
of stdout is one JSON object with all of it, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

P = 589_824      # scripts/dev/mfu_probe3.py:37
W, H, E, INS = 256, 128, 27, 32
VARIANTS = {"block_diagonal": False, "split": True}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(P: int, device, seed: int = 0):
    """[h, edT, M1, b1, Wrh2, M2, b2]: h and edT normals in bf16 (the probe's h0, edT), the
    operands of seeded flagship parameters through ``heads_operands``."""
    import torch

    from dmnerf_tpu_torch.core.mlp import init_dm_nerf
    from dmnerf_tpu_torch.kernels.head_probes import heads_operands

    params = init_dm_nerf(ins_num=INS, generator=torch.Generator().manual_seed(seed),
                          device=device)
    ops = heads_operands(params, 4)
    g = torch.Generator(device).manual_seed(seed)
    h = torch.randn(P, W, generator=g, device=device).to(torch.bfloat16)
    edT = torch.randn(E, P, generator=g, device=device).to(torch.bfloat16)
    return [h, edT] + [ops[k] for k in ("m1", "b1", "wrh2", "m2", "b2")]


def macs(split: bool) -> dict:
    """Multiply-accumulates a point: the probe's model count (mfu_probe4.py's fused head,
    M2 dense) and the instructions' (csrc/fused_mlp_fwd.cuh's widths: sigma n16 over 256,
    the head's ed box of 64 and h's 256 columns at n256, the output at n64 over 256, or n16
    over 128 and n64 over 128)."""
    model = W * (2 * H + 1) + E * H + 2 * H * (3 + INS + 1)
    out = H * 16 + H * 64 if split else 2 * H * 64
    return dict(model=model, executed=W * 16 + (64 + W) * 2 * H + out)


def library(args, split: bool):
    """The bf16 torch.addmm chain over the same blocks: the yardstick."""
    import torch

    h, edT, m1, b1, wrh2, m2, b2 = args
    bf = torch.bfloat16
    pre1 = torch.addmm(b1.to(bf), h, m1.to(bf))
    edc = torch.mm(edT.t(), wrh2.to(bf))
    rh = torch.relu(pre1[:, :H] + edc)
    ih = torch.relu(pre1[:, H:2 * H])
    if split:
        o = torch.cat([torch.addmm(b2[:3].to(bf), rh, m2[:H, :3].to(bf)),
                       torch.addmm(b2[3:].to(bf), ih, m2[H:, 3:].to(bf))], dim=1)
    else:
        o = torch.addmm(b2.to(bf), torch.cat([rh, ih], dim=1), m2.to(bf))
    return torch.cat([o[:, :3], pre1[:, 2 * H:], o[:, 3:]], dim=1).float().sum(1, keepdim=True)


def measure(device, reps: int = 5) -> dict:
    """The probe's numbers (module docstring). ``launches`` are the two calls of the
    probe's question, one a variant, through ``heads_fused``; the comparisons and timings
    come after them."""
    import torch

    from dmnerf_tpu_torch.kernels import head_probes as hpr
    from dmnerf_tpu_torch.kernels import runtime

    cs = _chip_smoke()
    args = inputs(P, device)
    runtime.reset_launches()
    outs = {v: hpr.heads_fused(*args, split=s) for v, s in VARIANTS.items()}
    torch.cuda.synchronize()
    res = {"points": P, "launches": {k: v for k, v in runtime.LAUNCHES.items() if v},
           "variants": {}}
    h, edT = args[:2]
    for v, split in VARIANTS.items():
        got = outs[v]
        ref = lambda a, s: hpr.heads_fused_ref(*args, split, a, s)[0]   # noqa: E731
        cmp = hpr.compare(got, ref(torch.float32, torch.float32),
                          ref(torch.bfloat16, torch.float32), ref(torch.bfloat16, torch.float64))
        ops = hpr.heads_fused_operands(*args[2:], split=split)
        dev = cs.device_ms(lambda: hpr._launch_probe("heads_fused", ops, h, edT), runs=reps)
        mc = macs(split)
        nbytes = (h.numel() + edT.numel()) * 2 + got.numel() * 4 + ops.wt.numel() * 2 \
            + ops.b.numel() * 4
        t_ops, t_bytes = 2.0 * mc["model"] * P / cs.PEAK_BF16_FLOPS * 1e3, nbytes / cs.PEAK_BYTES * 1e3
        ms = dev["device_ms"]
        r = dict(**cmp,
                 repeat_bit_identical=bool(torch.equal(got, hpr.heads_fused(*args, split=split))),
                 ms=ms, **dev,
                 plain_ms=cs._time_ms(lambda: hpr.heads_fused_ref(*args, split, torch.float32),
                                      reps=5),
                 library_ms=cs._time_ms(lambda: library(args, split), reps=10),
                 model_gflop=2.0 * mc["model"] * P / 1e9,
                 executed_gflop=2.0 * mc["executed"] * P / 1e9,
                 model_tflops=2.0 * mc["model"] * P / (ms * 1e-3) / 1e12,
                 executed_tflops=2.0 * mc["executed"] * P / (ms * 1e-3) / 1e12,
                 mbytes=nbytes / 1e6, bound_ms=max(t_ops, t_bytes),
                 executed_bound_ms=2.0 * mc["executed"] * P / cs.PEAK_BF16_FLOPS * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        r["library_max_abs_err"] = float((library(args, split)
                                          - ref(torch.float32, torch.float32)).abs().max())
        r["share_of_bound"] = r["bound_ms"] / ms
        res["variants"][v] = r
    res["answer"] = answer({v: r["ms"] for v, r in res["variants"].items()})
    runtime.reset_launches()
    return res


def answer(ms: dict) -> dict:
    """The probe's answer from each variant's ms: split against block-diagonal."""
    bd, sp = ms["block_diagonal"], ms["split"]
    return {"split-block_diagonal": {"us": (sp - bd) * 1e3, "share": (sp - bd) / bd}}


def launchers(device) -> dict:
    """For each variant, ``launch(schedule)``: one K10 launch over ``measure``'s inputs
    with the consumers under ``schedule`` (``fused_mlp.LOCKSTEP`` or ``PIPELINED``)."""
    from dmnerf_tpu_torch.kernels import head_probes as hpr

    args = inputs(P, device)
    return {v: (lambda sc, ops=hpr.heads_fused_operands(*args[2:], split=s):
                hpr._launch_probe("heads_fused", ops, args[0], args[1], sc))
            for v, s in VARIANTS.items()}


def check(res: dict) -> None:
    """The bars (``head_probes.compare``): the kernel vs its fp32 plain version within 5e-3
    * max(scale, 1), vs its bf16 one with exact sums within 5e-3 of the scale or twice
    PyTorch's own order floor; repeats bit-identical."""
    for k, r in res["variants"].items():
        if not r["ok"] or not r["repeat_bit_identical"]:
            raise AssertionError(f"heads_fused {k}: " + json.dumps(
                {kk: r[kk] for kk in ("out_scale", "max_abs_err", "max_abs_err_bf16_plain",
                                      "max_abs_err_bf16_exact", "order_floor", "bf16_bar",
                                      "repeat_bit_identical")}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5, help="device_ms runs of 50 launches")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        print("mfu_probe4_torch: needs a CUDA card of capability 9.0", file=sys.stderr)
        return 1
    from dmnerf_tpu_torch.kernels import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    runtime.build(["heads_fused"])
    cs = _chip_smoke()
    res = dict(card=cs.smi("name,power.limit"), device=torch.cuda.get_device_name(0),
               **measure(torch.device("cuda"), a.reps))
    for v, r in res["variants"].items():
        print(f"[heads_fused] {v}: {r['ms']:.4f} ms ({r['model_tflops']:.1f} model / "
              f"{r['executed_tflops']:.1f} executed TFLOP/s, {100 * r['share_of_bound']:.1f} % of "
              f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain {r['plain_ms']:.2f}, library "
              f"{r['library_ms']:.3f}; max|d| {r['max_abs_err']:.2e} fp32, {r['max_abs_err_bf16_plain']:.2e} bf16, "
              f"{r['max_abs_err_bf16_exact']:.2e} bf16 exact sums (floor {r['order_floor']:.2e}, "
              f"scale {r['out_scale']:.3f})", flush=True)
    ans = res["answer"]["split-block_diagonal"]
    print(f"[heads_fused] answer ({res['card']}): split - block-diagonal {ans['us']:+.2f} us "
          f"({100 * ans['share']:+.2f} %)", flush=True)
    check(res)
    line = json.dumps(res)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
