"""Scene manipulation (``dmnerf_tpu/render/manipulator.py``): per-sample raw exchange
between the original ray bundle and inverse-transformed target bundles, keyed by the
predicted instance labels.

 * ``exchange``: per-point labels are the argmax of the raw instance logits (air
   included); the occlusion fix gives a point that says "moved object" on a ray whose
   accumulated 2D label disagrees the accumulated label; the filling mask
   (accumulated == move, point != move) pulls the target bundle's sample; then
   {keep, eliminate (raw * 0), exchange} from (target move, original move), applied in
   order over the K moved objects with the labels carried between them. The returned
   target labels are those after the occlusion fix.
 * ``manipulate_rays``: pass 1 queries the original bundle coarse and each target
   bundle coarse, accumulates 2D labels with the fine model, and exchanges the coarse
   raws; pass 2 importance-samples the exchanged original weights, forms the union z
   set (64 ∪ 128 ∪ K x 128 target samples), queries the original and each target bundle
   with the fine model on it, exchanges again and composites. It also returns the last
   target bundle's coarse rgb and accumulated instance map.
 * ``make_manipulator_renderer``: a Python loop over chunks of ``cfg.N_test`` rays
   under ``torch.no_grad``, rays zero-padded to whole chunks, parameters prepared (for
   the kernel: packed) once per render. Under a profiler each chunk records the span
   ``mani.chunk`` (``utils.spans``).

Randomness: ``sample_pdf`` draws either come injected (``u``: a list of 2K+2
uniforms [n, N_importance] indexed like the JAX package's ``jax.random.split(key,
2K+2)``; entries 0, 1+k and K+1 are read) or from a ``torch.Generator``; with
neither, the draws are the deterministic linspace of the JAX package's ``key=None``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.compositor import composite, composite_maps
from dmnerf_tpu_torch.core.mlp import rgb_stub_params
from dmnerf_tpu_torch.core.pipeline import QueryFn, make_query_fn
from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample
from dmnerf_tpu_torch.utils.spans import span


def _point_labels(raw: torch.Tensor) -> torch.Tensor:
    """Per-sample instance labels (argmax over the logits, air included) [N, S]."""
    return torch.argmax(raw[..., 4:], dim=-1)


def _accum_labels(accum_ins: torch.Tensor) -> torch.Tensor:
    """Per-ray 2D labels from the accumulated (air-kept) instance map [N]."""
    return torch.argmax(accum_ins[..., :-1], dim=-1)


def exchange(
    ori_raw: torch.Tensor,                 # [N, S, C]
    tar_raws: Sequence[torch.Tensor],      # K x [N, S, C]
    ori_accum: torch.Tensor,               # [N, ins+1] accumulated, sigmoided (pass 1)
    tar_accums: Sequence[torch.Tensor],    # K x [N, ins+1]
    move_labels: Sequence[int],
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """(exchanged original raw, the target raws, original point labels, the last
    target's point labels after the occlusion fix)."""
    ori_pred = _point_labels(ori_raw)
    ori_acc = _accum_labels(ori_accum)[:, None].expand_as(ori_pred)

    tar_pred_last = None
    for k, move in enumerate(move_labels):
        tar_raw = tar_raws[k]
        tar_acc = _accum_labels(tar_accums[k])[:, None].expand_as(ori_pred)

        # occlusion fix on the original bundle
        ori_pred = torch.where((ori_pred == move) & (ori_acc != move), ori_acc, ori_pred)
        # fillings: the ray sees the moved object but this sample does not
        fillings = (ori_acc == move) & (ori_pred != move)

        tar_pred = _point_labels(tar_raw)
        tar_pred = torch.where((tar_pred == move) & (tar_acc != move), tar_acc, tar_pred)
        tar_pred_last = tar_pred

        # 0 neither, 1 target only, 2 original only, 3 both
        reduced = (tar_pred == move).int() + 2 * (ori_pred == move).int()
        take_tar = (reduced == 1) | (reduced == 3) | fillings
        eliminate = reduced == 2

        ori_raw = torch.where(take_tar[..., None], tar_raw, ori_raw)
        ori_raw = torch.where(eliminate[..., None], torch.zeros_like(ori_raw), ori_raw)

    return ori_raw, list(tar_raws), ori_pred, tar_pred_last


def _query_at(query_fn: QueryFn, prepared, rays_o, rays_d, z_vals):
    """The point query at explicit z; viewdirs are the normalized ray directions."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return query_fn.query(prepared, pts, viewdirs)


def _mani_composite(raw, z_vals, rays_d):
    """The manipulator's compositor: air kept, instance weights not detached."""
    return composite(raw, z_vals, rays_d, keep_air=True, detach_ins_weights=False)


def _mani_composite_maps(raw, z_vals, rays_d):
    """The final composite (rgb, ins with air, depth) by one reduction; the
    per-channel math is ``_mani_composite``'s."""
    return composite_maps(raw, z_vals, rays_d, keep_air=True)


def _prepare(query_fn: QueryFn, params_coarse, params_fine, rgb_stub: bool):
    """Prepared (coarse, fine, coarse for labels, fine for labels). With ``rgb_stub``
    the pass-1 label queries (original coarse, original fine, target fine) run with
    ``rgb_stub_params``: their rgb channels are never read (the 2D labels read the
    accumulated ins, the exchanged coarse weights read sigma). The target coarse query
    stays full because its rgb render is returned."""
    pc, pf = query_fn.prepare(params_coarse), query_fn.prepare(params_fine)
    if not rgb_stub:
        return pc, pf, pc, pf
    return (pc, pf, query_fn.prepare(rgb_stub_params(params_coarse)),
            query_fn.prepare(rgb_stub_params(params_fine)))


def _manipulate(cfg: Config, query_fn: QueryFn, prepared, ori_rays, tar_rays,
                move_labels: Sequence[int], u=None, generator=None) -> Dict[str, torch.Tensor]:
    pc, pf, pc_lbl, pf_lbl = prepared
    K = len(tar_rays)
    if K != len(move_labels):
        raise ValueError(f"{K} target bundles for {len(move_labels)} move labels")
    if u is not None and len(u) != 2 * K + 2:
        raise ValueError(f"want 2K+2 = {2 * K + 2} injected draws, got {len(u)}")

    def draws(i):
        return None if u is None else u[i]

    ori_o, ori_d = ori_rays
    n = ori_o.shape[0]
    z_base = z_val_sample(n, cfg.near, cfg.far, cfg.N_samples, dtype=ori_o.dtype,
                          device=ori_o.device)
    z_mid = 0.5 * (z_base[..., 1:] + z_base[..., :-1])

    def pdf(weights, i):
        return sample_pdf(z_mid, weights[..., 1:-1], cfg.N_importance, u=draws(i),
                          generator=generator)

    # ---- pass 1: coarse queries + fine-accumulated 2D labels
    ori_raw = _query_at(query_fn, pc_lbl, ori_o, ori_d, z_base)
    ori_zs = pdf(_mani_composite(ori_raw, z_base, ori_d).weights, 0)
    ori_z_full = torch.sort(torch.cat([z_base, ori_zs], -1), -1).values
    ori_raw_full = _query_at(query_fn, pf_lbl, ori_o, ori_d, ori_z_full)
    ori_accum = _mani_composite(ori_raw_full, ori_z_full, ori_d).ins     # [N, ins+1]

    tar_raws, tar_accums, tar_zs_list = [], [], []
    tar_rgb = tar_accum_last = None
    for k, (to, td) in enumerate(tar_rays):
        traw = _query_at(query_fn, pc, to, td, z_base)
        tcomp = _mani_composite(traw, z_base, td)
        tzs = pdf(tcomp.weights, 1 + k)
        tz_full = torch.sort(torch.cat([z_base, tzs], -1), -1).values
        traw_full = _query_at(query_fn, pf_lbl, to, td, tz_full)
        taccum = _mani_composite(traw_full, tz_full, td).ins
        tar_raws.append(traw)
        tar_accums.append(taccum)
        tar_zs_list.append(tzs)
        tar_rgb, tar_accum_last = tcomp.rgb, taccum

    # ---- exchange on the coarse raws
    ori_raw, tar_raws, _, _ = exchange(ori_raw, tar_raws, ori_accum, tar_accums, move_labels)

    # ---- pass 2: union-z re-query with the fine model
    ori_zs2 = pdf(_mani_composite(ori_raw, z_base, ori_d).weights, K + 1)
    z_union = torch.sort(torch.cat([z_base, ori_zs2, *tar_zs_list], -1), -1).values
    ori_raw_u = _query_at(query_fn, pf, ori_o, ori_d, z_union)
    tar_raws_u = [_query_at(query_fn, pf, to, td, z_union) for to, td in tar_rays]

    ori_raw_u, _, _, _ = exchange(ori_raw_u, tar_raws_u, ori_accum, tar_accums, move_labels)
    rgb, ins, depth = _mani_composite_maps(ori_raw_u, z_union, ori_d)
    return {
        "rgb": rgb,
        "ins": ins,                    # air channel kept
        "depth": depth,
        "tar_rgb": tar_rgb,            # the last target bundle's
        "tar_ins_accum": tar_accum_last,
    }


def manipulate_rays(
    cfg: Config,
    params_coarse,
    params_fine,
    ori_rays: Tuple[torch.Tensor, torch.Tensor],                # (o, d) each [N, 3]
    tar_rays: Sequence[Tuple[torch.Tensor, torch.Tensor]],      # K bundles
    move_labels: Sequence[int],
    query_fn: Optional[QueryFn] = None,
    u: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    rgb_stub: bool = True,
) -> Dict[str, torch.Tensor]:
    """One manipulated ray bundle (module docstring). Output-identical with
    ``rgb_stub`` on or off."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    prepared = _prepare(query_fn, params_coarse, params_fine, rgb_stub)
    return _manipulate(cfg, query_fn, prepared, ori_rays, tar_rays, move_labels, u, generator)


def make_manipulator_renderer(cfg: Config, n_targets: int, query_fn: Optional[QueryFn] = None):
    """Chunked full-image manipulation renderer. Returns fn(params_coarse,
    params_fine, ori_o [N,3], ori_d [N,3], tar_o [K,N,3], tar_d [K,N,3], move_labels,
    generator=None) -> dict(rgb [N,3], ins [N,ins+1], tar_rgb [N,3]).

    Without a generator the importance draws are the deterministic linspace; with one,
    each chunk draws from a generator of its own, seeded from it (the JAX package
    splits its key per chunk)."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    chunk = cfg.N_test

    def padded(x, pad):
        # explicit pad shape: [..., n, 3] -> [..., n + pad, 3] of zeros
        if pad:
            z = torch.zeros(x.shape[:-2] + (pad,) + x.shape[-1:], dtype=x.dtype, device=x.device)
            x = torch.cat([x, z], dim=-2)
        return x

    def guard(d):
        # padding rays get d = 1, not 0/0 viewdirs
        return torch.where(torch.sum(d * d, -1, keepdim=True) > 0, d, torch.ones_like(d))

    @torch.no_grad()
    def run(params_coarse, params_fine, ori_o, ori_d, tar_o, tar_d, move_labels,
            generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if tar_o.shape[0] != n_targets:
            raise ValueError(f"renderer built for {n_targets} targets, got {tar_o.shape[0]}")
        n = ori_o.shape[0]
        pad = (-n) % chunk
        ori_o_p, ori_d_p = padded(ori_o, pad), padded(ori_d, pad)
        tar_o_p, tar_d_p = padded(tar_o, pad), padded(tar_d, pad)
        nc = (n + pad) // chunk
        seeds = None
        if generator is not None:
            seeds = torch.randint(0, 2 ** 62, (nc,), generator=generator,
                                  device=generator.device).tolist()
        prepared = _prepare(query_fn, params_coarse, params_fine, rgb_stub=True)
        outs = []
        for c in range(nc):
            with span("mani.chunk", min(chunk, n - c * chunk)):
                s = slice(c * chunk, (c + 1) * chunk)
                gen = None
                if seeds is not None:
                    gen = torch.Generator(device=ori_o.device).manual_seed(seeds[c])
                out = _manipulate(cfg, query_fn, prepared, (ori_o_p[s], guard(ori_d_p[s])),
                                  [(tar_o_p[k, s], guard(tar_d_p[k, s]))
                                   for k in range(n_targets)],
                                  move_labels, generator=gen)
                outs.append({k: out[k] for k in ("rgb", "ins", "tar_rgb")})
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    return run


def deform_ray_offsets(H: int, W: int, deform_func: str, deform_v: float) -> np.ndarray:
    """Per-pixel-row x offsets for deformable edits (the reference's hard-coded
    400 / 50 / 200 / 215 constants are behavior). Returns a flat [H*W] float32 array
    to add to the ray origins' x."""
    v = np.linspace(1, H, H)
    if deform_func == "sin":
        v = np.sin((8 * np.pi) / 400 * v) * deform_v
    elif deform_func == "ex":
        v = np.exp(-v / 50.0)
    elif deform_func == "linear":
        v = (v - 200.0) / 215.0
    elif deform_func == "abs_linear":
        v = np.abs(v - 200.0) / 200.0
    elif deform_func == "ln":
        v = np.log(v / 200.0)
    else:
        raise ValueError(f"unknown deform_func {deform_func!r}")
    return np.repeat(v[:, None], W, axis=1).reshape(-1).astype(np.float32)
