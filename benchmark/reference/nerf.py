"""The plain DM-NeRF reference: the point query, sampling, compositing, the coarse-to-fine
render of a training batch and of a view, and the manipulator's two-pass exchange.

Written from DM-NeRF's equations in plain PyTorch; it imports nothing of the program.
Every matrix product goes through ``mm(x, w, prec)``:

 * ``fp32``: a float32 product, TF32 off (``fp32_matmul`` sets it);
 * ``bf16`` and ``fp8``: both operands rounded to bfloat16, or to float8 e4m3 after a
   per-tensor scale to its largest finite value (448), and multiplied in float32, in the
   backward too. ``fp8`` is the control: one step below the bfloat16 operands of the
   program's fused kernels. ``bf16`` stands for the program's own rounding in the CPU
   tests.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_matmul():
    """float32 products really in float32 on the card (TF32 off), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return x
    if prec == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if prec == "fp8":
        scale = FP8_MAX / torch.clamp(x.detach().abs().amax(), min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown precision {prec!r}")


class _RoundedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, prec):
        xr, wr = round_to(x, prec), round_to(w, prec)
        ctx.save_for_backward(xr, wr)
        ctx.prec = prec
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_to(g, ctx.prec)
        return gr @ wr.t(), xr.t() @ gr, None


def mm(x: torch.Tensor, w: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    if prec == "fp32":
        return x @ w
    shape = x.shape[:-1]
    return _RoundedMM.apply(x.reshape(-1, x.shape[-1]), w, prec).reshape(*shape, w.shape[-1])


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    parts = [x]
    for f in range(multires):
        parts += [torch.sin(x * 2.0 ** f), torch.cos(x * 2.0 ** f)]
    return torch.cat(parts, -1)


def query(params: Dict[str, torch.Tensor], pts: torch.Tensor, viewdirs: torch.Tensor,
          conf: dict, prec: str = "fp32") -> torch.Tensor:
    """raw [N, S, 3 + 1 + ins_num + 1] = [rgb, sigma, instance logits] of the points
    [N, S, 3] seen along viewdirs [N, 3]; the instance head reads the trunk feature
    detached."""
    e = embed(pts, conf["multires"])
    ev = embed(viewdirs, conf["multires_views"])[:, None, :].expand(*pts.shape[:-1], -1)

    def lin(name, x):
        return mm(x, params[f"{name}_w"], prec) + params[f"{name}_b"]

    h = e
    for i in range(conf["netdepth"]):
        h = torch.relu(lin(f"trunk_{i}", h))
        if i in conf["skips"]:
            h = torch.cat([h, e], -1)
    sigma = lin("density", h)
    rgb = lin("rgb_out", torch.relu(lin("rgb_hid", torch.cat([lin("rgb_feat", h), ev], -1))))
    ins = lin("ins_out", torch.relu(lin("ins_hid", lin("ins_feat", h.detach()))))
    return torch.cat([rgb, sigma, ins], -1)


def weights_of(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Compositing weights: alpha_i T_i, dists scaled by |d|, the last one 1e10, T the
    exclusive product of (1 - alpha) with 1 - alpha clamped at 1e-10 in the log."""
    dists = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    t = torch.exp(torch.cumsum(torch.log(torch.clamp(1.0 - alpha, min=1e-10)), -1))
    return alpha * torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], -1)


def composite(raw, z, rays_d, keep_air: bool = False, detach_ins: bool = True):
    """(rgb [N, 3], ins [N, C or C + 1], depth [N], weights [N, S]); the instance map is
    the sigmoid of the weighted logits, weighted by detached weights unless
    ``detach_ins`` is off, the air channel dropped unless ``keep_air``."""
    w = weights_of(raw, z, rays_d)
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    depth = (w * z).sum(-1)
    wi = w.detach() if detach_ins else w
    ins = torch.sigmoid((wi[..., None] * raw[..., 4:]).sum(-2))
    return rgb, (ins if keep_air else ins[..., :-1]), depth, w


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF samples at the uniforms ``u`` [N, n] of the piecewise-constant pdf of
    ``weights`` + 1e-5 over ``bins``."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def z_lin(n: int, conf: dict, device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, conf["N_samples"], device=device)
    return (conf["near"] + t * (conf["far"] - conf["near"])).expand(n, -1)


def det_u(n: int, k: int, device) -> torch.Tensor:
    """The deterministic draws of a pass without perturbation."""
    return torch.linspace(0.0, 1.0, k, device=device).expand(n, -1)


def points(o, d, z):
    return o[..., None, :] + d[..., None, :] * z[..., :, None]


def unit(d):
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def render_batch(pc, pf, o, d, conf: dict, u_z: Optional[torch.Tensor],
                 u_pdf: Optional[torch.Tensor], prec: str = "fp32") -> Dict[str, torch.Tensor]:
    """The training render of rays (o, d) [N, 3]: the stratified coarse z (jittered by
    ``u_z`` when given), the coarse query, importance samples at ``u_pdf`` on the
    detached coarse weights, the fine query on the sorted union."""
    n = o.shape[0]
    z = z_lin(n, conf, o.device)
    if u_z is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper, lower = torch.cat([mids, z[..., -1:]], -1), torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * u_z
    vd = unit(d)
    raw_c = query(pc, points(o, d, z), vd, conf, prec)
    rgb_c, ins_c, depth_c, w_c = composite(raw_c, z, d)
    if u_pdf is None:
        u_pdf = det_u(n, conf["N_importance"], o.device)
    zs = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), w_c[..., 1:-1].detach(), u_pdf).detach()
    zf = torch.sort(torch.cat([z, zs], -1), -1).values
    raw_f = query(pf, points(o, d, zf), vd, conf, prec)
    rgb_f, ins_f, depth_f, _ = composite(raw_f, zf, d)
    return dict(rgb_coarse=rgb_c, ins_coarse=ins_c, depth_coarse=depth_c, raw_coarse=raw_c,
                z_coarse=z, rgb_fine=rgb_f, ins_fine=ins_f, depth_fine=depth_f, raw_fine=raw_f,
                z_fine=zf)


@torch.no_grad()
def render_view(pc, pf, o, d, conf: dict, prec: str = "fp32", chunk: int = 2048):
    """(rgb [N, 3], ins [N, ins_num]) of a view's rays without perturbation, in blocks
    of ``chunk`` rays."""
    rgbs, inss = [], []
    for c0 in range(0, o.shape[0], chunk):
        out = render_batch(pc, pf, o[c0:c0 + chunk], d[c0:c0 + chunk], conf, None, None, prec)
        rgbs.append(out["rgb_fine"])
        inss.append(out["ins_fine"])
    return torch.cat(rgbs), torch.cat(inss)


def _labels(raw):
    return torch.argmax(raw[..., 4:], -1)


def exchange(ori_raw, tar_raws: Sequence[torch.Tensor], ori_accum, tar_accums,
             moves: Sequence[int]) -> torch.Tensor:
    """DM-NeRF's per-sample exchange: a sample's label is the argmax of its logits (air
    included), a ray's the argmax of its accumulated map without air; a sample that says
    "moved object" on a ray that does not takes the ray's label; then per moved object:
    the target's sample where the target sees the object (or the ray sees it and the
    sample does not), nothing where only the original sees it."""
    ori = _labels(ori_raw)
    acc = torch.argmax(ori_accum[..., :-1], -1)[:, None].expand_as(ori)
    for k, move in enumerate(moves):
        tacc = torch.argmax(tar_accums[k][..., :-1], -1)[:, None].expand_as(ori)
        ori = torch.where((ori == move) & (acc != move), acc, ori)
        fill = (acc == move) & (ori != move)
        tar = _labels(tar_raws[k])
        tar = torch.where((tar == move) & (tacc != move), tacc, tar)
        t_in, o_in = tar == move, ori == move
        take = (t_in & ~o_in) | (t_in & o_in) | fill
        ori_raw = torch.where(take[..., None], tar_raws[k], ori_raw)
        ori_raw = torch.where((o_in & ~t_in)[..., None], torch.zeros_like(ori_raw), ori_raw)
    return ori_raw


@torch.no_grad()
def manipulate(pc, pf, ori, tars, moves: Sequence[int], conf: dict, u: Sequence[torch.Tensor],
               prec: str = "fp32"):
    """(rgb [N, 3], ins [N, ins_num + 1]) of one block of a manipulated view: ``ori`` the
    view's rays (o, d), ``tars`` K target bundles, ``u`` the K + 2 importance draws of
    the block (entry 0 the original's first pass, 1 + k target k's, K + 1 the second
    pass). Pass 1 queries each bundle coarse, importance-samples it and accumulates its
    labels with the fine model; the coarse raws are exchanged; pass 2 importance-samples
    the exchanged weights, queries every bundle with the fine model on the union of all
    samples, exchanges again and composites (air kept, instance weights attached)."""
    o, d = ori
    n = o.shape[0]
    z = z_lin(n, conf, o.device)
    mid = 0.5 * (z[..., 1:] + z[..., :-1])

    def q(p, oo, dd, zz):
        return query(p, points(oo, dd, zz), unit(dd), conf, prec)

    def comp(raw, zz, dd):
        return composite(raw, zz, dd, keep_air=True, detach_ins=False)

    def pdf(raw, dd, i):
        return sample_pdf(mid, comp(raw, z, dd)[3][..., 1:-1], u[i])

    ori_raw = q(pc, o, d, z)
    ori_zs = pdf(ori_raw, d, 0)
    zf = torch.sort(torch.cat([z, ori_zs], -1), -1).values
    ori_accum = comp(q(pf, o, d, zf), zf, d)[1]
    tar_raws, tar_accums, tar_zs = [], [], []
    for k, (to, td) in enumerate(tars):
        traw = q(pc, to, td, z)
        tzs = pdf(traw, td, 1 + k)
        tzf = torch.sort(torch.cat([z, tzs], -1), -1).values
        tar_accums.append(comp(q(pf, to, td, tzf), tzf, td)[1])
        tar_raws.append(traw)
        tar_zs.append(tzs)
    ori_raw = exchange(ori_raw, tar_raws, ori_accum, tar_accums, moves)
    zs2 = pdf(ori_raw, d, len(tars) + 1)
    zu = torch.sort(torch.cat([z, zs2, *tar_zs], -1), -1).values
    raw_u = exchange(q(pf, o, d, zu), [q(pf, to, td, zu) for to, td in tars],
                     ori_accum, tar_accums, moves)
    rgb, ins, _, _ = comp(raw_u, zu, d)
    return rgb, ins
