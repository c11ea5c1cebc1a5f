"""Training-trajectory parity of the kernel query against the plain PyTorch query
(``dmnerf_tpu/tools/train_parity.py``, its ``--vs xla`` mode).

The port trained three times from the same initial parameters, on the same ray
batches (precomputed once with numpy), with perturb = 0 (no draws on any side) and the
same Adam with exponential LR decay, differing only in the point query:

  kernel   the fused kernels (``core.pipeline.make_query_fn``; on the card K1 and K2,
           or the pair of ``pallas_pe_mode``)
  plain    the plain fp32 PyTorch query (``make_torch_query_fn``), the reference
  control  the kernels' own function in PyTorch ops with their bf16 roundings
           (``query_fwd`` / ``query_bwd`` at bfloat16): it differs
           from the kernel only in the order of its fp32 sums, so its distance from
           the plain run is what bf16 rounding alone does to the trajectory

Each run records the train batch's PSNR, instance loss, penalizer and total loss at
fixed iterations, then renders a held-out view and scores its PSNR and instance mAP.
On the CPU the fused query is its fp32 plain version, so the kernel and plain runs
differ only by the order of their fp32 sums.

CLI:  python -m dmnerf_tpu_torch.tools.train_parity [--vs plain] [--iters 2000]
      [--record-every 250] [--geometry {tiny,flagship}] [--seed 0] [--out FILE]
      [--json-out FILE] [--device cpu]
Writes a markdown table (and the JSON of the result with ``--json-out``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.pipeline import QueryFn, make_query_fn, make_torch_query_fn
from dmnerf_tpu_torch.core.rays import rays_for_pixels, rays_from_K
from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene
from dmnerf_tpu_torch.kernels.fused_mlp import pack_params, query_bwd, query_fwd, resolve_pe_mode
from dmnerf_tpu_torch.objfield.metrics import compact_gt_one_hot_np, ins_eval
from dmnerf_tpu_torch.render.renderer import make_image_renderer
from dmnerf_tpu_torch.render.trainstep import Batch, create_train_state, make_train_step
from dmnerf_tpu_torch.test import init_params
from dmnerf_tpu_torch.utils.device import resolve_device
from dmnerf_tpu_torch.utils.image_metrics import psnr_np

NEAR, FAR = 2.0, 7.0
LRATE, LRATE_DECAY = 5e-4, 500
TOLERANCE, DETA_W = 0.05, 0.05

GEOMETRIES = {
    "tiny": dict(D=4, W=64, MULTIRES=6, MULTIRES_VIEWS=3, SKIPS=(2,),
                 N_SAMPLES=16, N_IMPORTANCE=16, N_TRAIN=128, SCENE_HW=32),
    # the reference training schedule: 8x256 net, 64+128 samples; 3072 rays need a
    # 64x64 scene (pixel picks are without replacement)
    "flagship": dict(D=8, W=256, MULTIRES=10, MULTIRES_VIEWS=4, SKIPS=(4,),
                     N_SAMPLES=64, N_IMPORTANCE=128, N_TRAIN=3072, SCENE_HW=64),
}


def make_config(geometry: str, ins_num: int) -> Config:
    g = GEOMETRIES[geometry]
    return Config(
        netdepth=g["D"], netwidth=g["W"], multires=g["MULTIRES"],
        multires_views=g["MULTIRES_VIEWS"], skips=g["SKIPS"], N_samples=g["N_SAMPLES"],
        N_importance=g["N_IMPORTANCE"], N_train=g["N_TRAIN"], N_test=512, near=NEAR, far=FAR,
        ins_num=ins_num, lrate=LRATE, lrate_decay=LRATE_DECAY, perturb=0.0,
        penalize=True, tolerance=TOLERANCE, deta_w=DETA_W,
    )


def build_scene(geometry: str):
    """The JAX tool's synthetic DM-SR scene (6 train and 3 test views, 3 objects,
    ins_num 8), built in memory, and the run's config."""
    hw = GEOMETRIES[geometry]["SCENE_HW"]
    scene = build_dmsr_scene(n_train=6, n_test=3, H=hw, W=hw, n_objects=3, ins_num=8,
                             views=4)
    return scene, make_config(geometry, scene.ins_num)


def precompute_batches(scene, n_iters: int, n_train: int, seed: int = 0) -> List[Dict]:
    """The shared random stream, the JAX tool's: per step an image pick and distinct
    pixel ids from one numpy RandomState, and the rays and targets they give."""
    rng = np.random.RandomState(seed)
    Hh, Ww = scene.images.shape[1:3]
    K = torch.as_tensor(scene.K)
    batches = []
    for _ in range(n_iters):
        img_i = scene.i_train[rng.randint(0, len(scene.i_train))]
        flat = rng.choice(Hh * Ww, size=n_train, replace=False)
        py, px = flat // Ww, flat % Ww
        ro, rd = rays_for_pixels(torch.as_tensor(py), torch.as_tensor(px), K,
                                 torch.as_tensor(scene.poses[img_i]))
        batches.append(dict(rays_o=ro.numpy(), rays_d=rd.numpy(),
                            target_c=scene.images[img_i][py, px].astype(np.float32),
                            target_i=scene.gt_labels[img_i][py, px].astype(np.int64)))
    return batches


def _on(params, device):
    """Parameters given as tensors or numpy arrays, as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).to(device)
            for k, v in params.items()}


class _Bf16PlainQuery(torch.autograd.Function):
    """The kernels' functions in PyTorch ops with their bf16 roundings, differentiable
    in ``Packed.w`` and ``Packed.b`` as ``fused_query`` is."""

    @staticmethod
    def forward(ctx, w, b, packed, pts, viewdirs, mode):
        ctx.packed, ctx.mode = packed, mode
        ctx.save_for_backward(pts, viewdirs)
        return query_fwd(packed, pts, viewdirs, mode, torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        pts, viewdirs = ctx.saved_tensors
        dw, db = query_bwd(ctx.packed, pts, viewdirs, g, ctx.mode, torch.bfloat16)
        return dw, db, None, None, None, None


def make_bf16_plain_query_fn(cfg: Config) -> QueryFn:
    """The control query: the plain versions of the kernels of ``cfg.pallas_pe_mode`` at
    bfloat16."""
    mode = resolve_pe_mode(cfg.pallas_pe_mode)

    def prepare(params):
        return pack_params(params, cfg.multires, cfg.multires_views, cfg.netdepth,
                           tuple(cfg.skips))

    def query(packed, pts, viewdirs):
        return _Bf16PlainQuery.apply(packed.w, packed.b, packed, pts, viewdirs, mode)

    return QueryFn(query, prepare)


def _query_fn(cfg: Config, query: str) -> QueryFn:
    if query == "kernel":
        return make_query_fn(cfg)
    if query == "control":
        return make_bf16_plain_query_fn(cfg)
    return make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))


def run_ours(cfg: Config, params_c, params_f, scene, batches, record_at, query: str,
             device=None) -> Dict:
    """Train from (params_c, params_f) on ``batches`` with the ``query`` ('kernel':
    the config's fused query, 'plain' or 'control'), then score the first test view."""
    device = resolve_device(device)
    query_fn = _query_fn(cfg, query)
    state = create_train_state(cfg, _on(params_c, device), _on(params_f, device))
    step = make_train_step(cfg, query_fn=query_fn)

    trace = {}
    for it, b in enumerate(batches):
        batch = Batch(*(torch.from_numpy(np.array(b[k])).to(device)
                        for k in ("rays_o", "rays_d", "target_c", "target_i")))
        aux = step(state, batch)
        if (it + 1) in record_at:
            trace[it + 1] = {"psnr_fine": float(aux["psnr_fine"]),
                             "ins_loss": float(aux["ins_loss"]),
                             "emptiness": float(aux["emptiness_loss"]),
                             "total": float(aux["total_loss"])}

    i = scene.i_test[0]
    Hh, Ww = scene.images.shape[1:3]
    ro, rd = rays_from_K(Hh, Ww, torch.as_tensor(scene.K, device=device),
                         torch.as_tensor(scene.poses[i], device=device))
    out = make_image_renderer(cfg, query_fn=query_fn)(state.params_coarse, state.params_fine,
                                                      ro.reshape(-1, 3), rd.reshape(-1, 3))
    rgb = out["rgb"].cpu().numpy().reshape(Hh, Ww, 3)
    ins = out["ins"].cpu().numpy().reshape(Hh, Ww, -1)
    gt_onehot, valid_num, _ = compact_gt_one_hot_np(scene.gt_labels[i], scene.ins_num)
    _, ap, _ = ins_eval(ins, gt_onehot, valid_num, scene.ins_num)
    return {"trace": trace, "eval": {"psnr": float(psnr_np(rgb, scene.images[i])),
                                     "ap": [float(a) for a in np.asarray(ap).reshape(-1)]}}


def _diff_rows(ours: Dict, ref: Dict, ctl: Dict) -> List[Dict]:
    rows = []
    for it in sorted(ours["trace"]):
        o, r, c = ours["trace"][it], ref["trace"][it], ctl["trace"][it]
        rows.append({"iter": it,
                     "psnr_ours": o["psnr_fine"], "psnr_ref": r["psnr_fine"],
                     "psnr_ctl": c["psnr_fine"],
                     "ins_ours": o["ins_loss"], "ins_ref": r["ins_loss"],
                     "pen_ours": o["emptiness"], "pen_ref": r["emptiness"],
                     "total_ours": o["total"], "total_ref": r["total"],
                     "total_ctl": c["total"]})
    return rows


def _gaps(rows: List[Dict], side: str) -> Dict:
    """The largest |ΔPSNR| and |Δtotal| / total of ``side`` against the plain run."""
    return {"psnr": max(abs(r[f"psnr_{side}"] - r["psnr_ref"]) for r in rows),
            "total": max(abs(r[f"total_{side}"] - r["total_ref"]) / abs(r["total_ref"])
                         for r in rows)}


def run_query_parity(n_iters: int, record_every: int, geometry: str = "tiny", seed: int = 0,
                     device=None) -> Dict:
    """The kernel-query and the control run against the plain-query run, from the
    seeded init."""
    device = resolve_device(device)
    scene, cfg = build_scene(geometry)
    cfg = cfg.replace(seed=seed)
    params_c, params_f = init_params(cfg, device)
    record_at = set(range(record_every, n_iters + 1, record_every)) | {1, n_iters}
    batches = precompute_batches(scene, n_iters, cfg.N_train, seed)
    res, walls = {}, {}
    for query in ("kernel", "plain", "control"):
        t0 = time.time()
        res[query] = run_ours(cfg, params_c, params_f, scene, batches, record_at, query, device)
        walls[query] = time.time() - t0
    rows = _diff_rows(res["kernel"], res["plain"], res["control"])
    return {"rows": rows, "gap_ours": _gaps(rows, "ours"), "gap_ctl": _gaps(rows, "ctl"),
            "eval_ours": res["kernel"]["eval"], "eval_ref": res["plain"]["eval"],
            "eval_ctl": res["control"]["eval"],
            "wall_ours_s": walls["kernel"], "wall_ref_s": walls["plain"],
            "wall_ctl_s": walls["control"],
            "labels": {"ours": "kernel query", "ref": "plain query",
                       "ctl": "bf16 plain query (control)"},
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "schedule": {"iters": n_iters, "N_train": cfg.N_train,
                         "net": f"{cfg.netdepth}x{cfg.netwidth}",
                         "samples": [cfg.N_samples, cfg.N_importance], "seed": seed,
                         "geometry": geometry, "compare": "kernel-vs-plain"}}


def _rel(a: float, ref: float) -> float:
    return (a - ref) / abs(ref)


def write_report(res: Dict, out_md: str) -> None:
    lo, lr, lc = res["labels"]["ours"], res["labels"]["ref"], res["labels"]["ctl"]
    go, gc = res["gap_ours"], res["gap_ctl"]
    lines = [
        f"# Training-trajectory parity: {lo} vs {lr}, with the {lc}",
        "",
        "Identical init params, identical injected ray batches, perturb=0, identical",
        "Adam + exp LR decay; each side records its own train metrics and evaluates a",
        "held-out view. The control is the kernels' function in PyTorch ops with their",
        "bf16 roundings: its distance from the plain run is bf16 rounding alone.",
        "Produced by `python -m dmnerf_tpu_torch.tools.train_parity --vs plain`.",
        "",
        f"Device: {res['device']}. Schedule: {res['schedule']}",
        "",
        f"Largest gap to the {lr}: {lo} |ΔPSNR| {go['psnr']:.4f} dB, |Δtotal| / total "
        f"{go['total']:.2e}; {lc} {gc['psnr']:.4f} dB, {gc['total']:.2e}.",
        "",
        f"| iter | PSNR {lr} | PSNR {lo} | Δ | PSNR control | Δ control | ins_loss {lo} "
        f"| ins_loss {lr} | pen {lo} | pen {lr} | total {lr} | Δtotal / total "
        f"| Δtotal / total control |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in res["rows"]:
        lines.append(
            f"| {r['iter']} | {r['psnr_ref']:.4f} | {r['psnr_ours']:.4f} "
            f"| {r['psnr_ours'] - r['psnr_ref']:+.4f} | {r['psnr_ctl']:.4f} "
            f"| {r['psnr_ctl'] - r['psnr_ref']:+.4f} | {r['ins_ours']:.5f} "
            f"| {r['ins_ref']:.5f} | {r['pen_ours']:.5f} | {r['pen_ref']:.5f} "
            f"| {r['total_ref']:.5f} | {_rel(r['total_ours'], r['total_ref']):+.2e} "
            f"| {_rel(r['total_ctl'], r['total_ref']):+.2e} |")
    lines += [
        "",
        "## Held-out view (end of schedule)",
        "",
        "| | PSNR | AP@[.5,.75,.8,.85,.9,.95] |",
        "|---|---|---|",
    ]
    for label, key in ((lo, "eval_ours"), (lr, "eval_ref"), (lc, "eval_ctl")):
        e = res[key]
        lines.append(f"| {label} | {e['psnr']:.4f} | {['%.3f' % a for a in e['ap']]} |")
    lines += ["", f"Wall clock: {lo} {res['wall_ours_s']:.1f}s, {lr} {res['wall_ref_s']:.1f}s, "
              f"{lc} {res['wall_ctl_s']:.1f}s."]
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vs", choices=["plain"], default="plain",
                    help="the other side: the plain PyTorch query")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--record-every", type=int, default=250)
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="tiny")
    ap.add_argument("--seed", type=int, default=0, help="the init's and the batches' seed")
    ap.add_argument("--out", default="train_parity_plain.md")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain side is really fp32
    res = run_query_parity(args.iters, args.record_every, args.geometry, args.seed,
                           device=args.device)
    write_report(res, args.out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)
    for r in res["rows"]:
        print(f"iter {r['iter']:5d}: PSNR plain {r['psnr_ref']:.4f} kernel Δ "
              f"{r['psnr_ours'] - r['psnr_ref']:+.4f} control Δ {r['psnr_ctl'] - r['psnr_ref']:+.4f}"
              f" | total Δ/total kernel {_rel(r['total_ours'], r['total_ref']):+.2e} "
              f"control {_rel(r['total_ctl'], r['total_ref']):+.2e}")
    go, gc = res["gap_ours"], res["gap_ctl"]
    print(f"largest gap to plain: kernel {go['psnr']:.4f} dB, {go['total']:.2e}; "
          f"control {gc['psnr']:.4f} dB, {gc['total']:.2e}")
    for name, key in (("kernel", "eval_ours"), ("plain", "eval_ref"), ("control", "eval_ctl")):
        print(f"eval {name}: PSNR {res[key]['psnr']:.4f} AP@.5 {res[key]['ap'][0]:.3f}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
