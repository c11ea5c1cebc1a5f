"""The head-width probe on the port: K9 (``kernels/head_probes.py`` ``head512``) in its
four modes on the card. The question of scripts/dev/head512_probe.py, asked of the
port's forward template: its sigma is an n16 ``wgmma`` layer of its own (mode d); would a
CUDA-core dot of h with the density row beside the head's products (mode b) cost less?

    python3 scripts/head512_probe_torch.py [--reps 5] [--out FILE]

At the probe's P = 786,432 points and its inputs (x normals, weights normals * 0.05, bf16,
seeded), for each mode a (head [256, 513]: two n256 passes and an n16 one), b ([256, 512]
and the CUDA-core sigma), c ([256, 512] alone) and d ([256, 512] and the n16 sigma layer):

  * ms: the launch's device time, ``chip_smoke.device_ms`` (50 back-to-back launches with
    the card held busy while they are enqueued, the median of ``--reps`` runs);
  * TFLOP/s on model FLOPs (the products the probe's function needs: trunk, head columns,
    the sigma dot) and on executed FLOPs (what the instructions do: mode a's 513th column
    and d's sigma are n16 passes), and the share of the bound (model FLOPs over 989
    TFLOP/s or bytes over 3.35 TB/s, the larger);
  * plain_ms: ``head512_ref`` in fp32 (CUDA events, median of 5); library_ms: the bf16
    torch.mm chain over the same blocks (a yardstick the port never calls);
  * max|Δ| against the fp32 plain version, the bf16 one (the same roundings) and the bf16
    one with exact sums, and PyTorch's own order floor (``head_probes.compare``), and
    whether two launches are bit-identical.

Then the answer: a - c, b - c and d - c in microseconds and as a share of c. Needs a card
of capability 9.0. The last line of stdout is one JSON object with all of it, also
appended to ``--out``.
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

P = 786_432      # scripts/dev/head512_probe.py:27
W, D = 256, 8


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(mode: str, P: int, device, seed: int = 1):
    """x [P, 256], the trunk and head weights and wd (b, d), bf16, as the probe makes
    them (normals; the weights times 0.05) from ``seed``."""
    import torch

    g = torch.Generator(device).manual_seed(seed)
    rnd = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=device) * k).to(torch.bfloat16)  # noqa: E731
    x = rnd(P, W)
    ws = [rnd(W, W, k=0.05) for _ in range(D)] + [rnd(W, 2 * W + (mode == "a"), k=0.05)]
    return x, ws, (rnd(1, W, k=0.05) if mode in "bd" else None)


def macs(mode: str) -> dict:
    """Multiply-accumulates a point: the function's (model) and the instructions' (the
    n16 passes of mode a's 513th column and d's sigma layer; b's dot on the CUDA cores)."""
    trunk, head = D * W * W, W * (2 * W + (mode == "a"))
    model = trunk + head + (W if mode in "bd" else 0)
    executed = trunk + W * 2 * W + (W * 16 if mode in "ad" else 0) + (W if mode == "b" else 0)
    return dict(model=model, executed=executed)


def library(mode, x, ws, wd):
    """The bf16 torch.mm chain over the same blocks: the yardstick."""
    import torch

    h = x
    for w in ws[:-1]:
        h = torch.relu(torch.mm(h, w))
    head = torch.mm(h, ws[-1])
    if wd is None:
        return head[:, :32]
    return torch.cat([head[:, :31], torch.mm(h, wd.t())], dim=1)


def measure(device, reps: int = 5) -> dict:
    """The probe's numbers (module docstring). ``launches`` are the four calls of the
    probe's question, one a mode, through ``head512``; the comparisons and timings come
    after them."""
    import torch

    from dmnerf_tpu_torch.kernels import head_probes as hpr
    from dmnerf_tpu_torch.kernels import runtime

    cs = _chip_smoke()
    data = {m: inputs(m, P, device) for m in hpr.H512_MODES}
    runtime.reset_launches()
    outs = {m: hpr.head512(m, *data[m]) for m in hpr.H512_MODES}
    torch.cuda.synchronize()
    res = {"points": P, "launches": {k: v for k, v in runtime.LAUNCHES.items() if v}, "modes": {}}
    for m in hpr.H512_MODES:
        x, ws, wd = data[m]
        got = outs[m]
        ref = lambda a, s: hpr.head512_ref(m, x, ws, wd, a, sum_dtype=s)   # noqa: E731
        cmp = hpr.compare(got, ref(torch.float32, torch.float32),
                          ref(torch.bfloat16, torch.float32), ref(torch.bfloat16, torch.float64))
        ops = hpr.head512_operands(m, ws, wd)
        dev = cs.device_ms(lambda: hpr._launch_probe("head512", ops, x, None), runs=reps)
        mc = macs(m)
        nbytes = x.numel() * 2 + got.numel() * 4 + ops.wt.numel() * 2 + ops.b.numel() * 4
        t_ops, t_bytes = 2.0 * mc["model"] * P / cs.PEAK_BF16_FLOPS * 1e3, nbytes / cs.PEAK_BYTES * 1e3
        ms = dev["device_ms"]
        r = dict(**cmp, repeat_bit_identical=bool(torch.equal(got, hpr.head512(m, x, ws, wd))),
                 ms=ms, **dev,
                 plain_ms=cs._time_ms(lambda: hpr.head512_ref(m, x, ws, wd, torch.float32), reps=5),
                 library_ms=cs._time_ms(lambda: library(m, x, ws, wd), reps=10),
                 model_gflop=2.0 * mc["model"] * P / 1e9,
                 executed_gflop=2.0 * mc["executed"] * P / 1e9,
                 model_tflops=2.0 * mc["model"] * P / (ms * 1e-3) / 1e12,
                 executed_tflops=2.0 * mc["executed"] * P / (ms * 1e-3) / 1e12,
                 mbytes=nbytes / 1e6, bound_ms=max(t_ops, t_bytes),
                 executed_bound_ms=2.0 * mc["executed"] * P / cs.PEAK_BF16_FLOPS * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        r["library_max_abs_err"] = float((library(m, x, ws, wd).float()
                                          - ref(torch.float32, torch.float32)).abs().max())
        r["share_of_bound"] = r["bound_ms"] / ms
        res["modes"][m] = r
    c = res["modes"]["c"]["ms"]
    res["answer"] = {f"{m}-c": {"us": (res["modes"][m]["ms"] - c) * 1e3,
                                "share_of_c": (res["modes"][m]["ms"] - c) / c} for m in "abd"}
    runtime.reset_launches()
    return res


def check(res: dict) -> None:
    """The bars (``head_probes.compare``): the kernel vs its fp32 plain version within 5e-3
    * max(scale, 1), vs its bf16 one with exact sums within 5e-3 of the scale or twice
    PyTorch's own order floor; repeats bit-identical."""
    for k, r in res["modes"].items():
        if not r["ok"] or not r["repeat_bit_identical"]:
            raise AssertionError(f"head512 {k}: " + json.dumps(
                {kk: r[kk] for kk in ("out_scale", "max_abs_err", "max_abs_err_bf16_plain",
                                      "max_abs_err_bf16_exact", "order_floor", "bf16_bar",
                                      "repeat_bit_identical")}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5, help="device_ms runs of 50 launches")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        print("head512_probe_torch: needs a CUDA card of capability 9.0", file=sys.stderr)
        return 1
    from dmnerf_tpu_torch.kernels import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    runtime.build(["head512"])
    cs = _chip_smoke()
    res = dict(card=cs.smi("name,power.limit"), device=torch.cuda.get_device_name(0),
               **measure(torch.device("cuda"), args.reps))
    for m, r in res["modes"].items():
        print(f"[head512] {m}: {r['ms']:.4f} ms ({r['model_tflops']:.1f} model / "
              f"{r['executed_tflops']:.1f} executed TFLOP/s, {100 * r['share_of_bound']:.1f} % of "
              f"{r['bound_ms']:.4f} ms), plain {r['plain_ms']:.2f}, library {r['library_ms']:.3f}; "
              f"max|d| {r['max_abs_err']:.2e} fp32, {r['max_abs_err_bf16_plain']:.2e} bf16, "
              f"{r['max_abs_err_bf16_exact']:.2e} bf16 exact sums (floor {r['order_floor']:.2e}, "
              f"scale {r['out_scale']:.3f})", flush=True)
    a = res["answer"]
    print(f"[head512] answer ({res['card']}): " + ", ".join(
        f"{k} {v['us']:+.2f} us ({100 * v['share_of_c']:+.2f} % of c)" for k, v in a.items()),
        flush=True)
    check(res)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
