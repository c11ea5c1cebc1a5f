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
 * ``make_manipulator_renderer``: chunks of ``cfg.N_test`` rays under
   ``torch.no_grad``, rays zero-padded to whole chunks, parameters prepared (for the
   kernel: packed) once per render. Under a profiler each chunk records the span
   ``mani.chunk`` (``utils.spans``).

On the card every chunk is a replay of one CUDA graph (``_ChunkGraph``), which holds the
whole of ``_manipulate`` for the renderer's K targets: both passes' point queries, both
exchanges, the composites and the union sort. A renderer's first render warms the chunk
up on a side stream and captures it (``utils.device.capture_graph``, as the image
renderer does). The graph reads static buffers: one chunk's rays [1 + K, N_test, 6]
(the original's, then each target's; origins, then directions; the padding rays'
guard runs in the graph), the K+2 importance uniforms [K+2, N_test, N_importance], the
move labels [K] (int64; the exchange compares against each, so one graph serves any
labels) and the four prepared parameter sets, into which every render first copies the
ones it is given. It writes rgb, ins (air kept) and tar_rgb side by side into one static
[N_test, 3 + ins_num + 1 + 3]. A render draws each chunk's uniforms into their buffer
from the chunk's generator in the eager order (``draw_ahead``), or fills it once with
the linspace without a generator, copies the chunk's rays in, replays and copies the
maps out: nothing goes to the host inside the loop. Rays of another device or dtype,
parameters of other shapes or another K raise; a failed capture or replay raises, and
there is no eager path on the card. On the CPU the chunks run eagerly, one by one
(``fn.eager``). Both give the same maps, bit for bit: the same kernels run in the same
order on the same inputs and draws. ``exchange`` and ``composite_maps`` are looked up in
this module's globals when the chunk runs, which on the card is at capture.

Randomness: ``sample_pdf`` draws either come injected (``u``: at least K+2 uniforms
[n, N_importance], such as the JAX package's ``jax.random.split(key, 2K+2)``; entries
0, 1+k and K+1 are read) or from a ``torch.Generator``; with neither, the draws are the
deterministic linspace of the JAX package's ``key=None``.
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
from dmnerf_tpu_torch.utils.device import capture_graph, copy_params, static_params
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
    if u is not None and len(u) < K + 2:
        raise ValueError(f"want at least K+2 = {K + 2} injected draws, got {len(u)}")

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
    generator=None) -> dict(rgb [N,3], ins [N,ins+1], tar_rgb [N,3]) on the rays'
    device; on the card each chunk is a CUDA graph replay (``_ChunkGraph``).
    ``fn.eager`` is the same render with the chunks run one by one, the CPU's path.

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

    def chunk_seeds(generator, nc):
        """One seed a chunk, drawn from the caller's generator; None without one."""
        if generator is None:
            return None
        return torch.randint(0, 2 ** 62, (nc,), generator=generator,
                             device=generator.device).tolist()

    @torch.no_grad()
    def run_eager(params_coarse, params_fine, ori_o, ori_d, tar_o, tar_d, move_labels,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if tar_o.shape[0] != n_targets:
            raise ValueError(f"renderer built for {n_targets} targets, got {tar_o.shape[0]}")
        n = ori_o.shape[0]
        pad = (-n) % chunk
        ori_o_p, ori_d_p = padded(ori_o, pad), padded(ori_d, pad)
        tar_o_p, tar_d_p = padded(tar_o, pad), padded(tar_d, pad)
        nc = (n + pad) // chunk
        seeds = chunk_seeds(generator, nc)
        prepared = _prepare(query_fn, params_coarse, params_fine, rgb_stub=True)
        outs = []
        for c in range(nc):
            with span("mani.chunk", min(chunk, n - c * chunk)):
                s = slice(c * chunk, (c + 1) * chunk)
                gen = None
                if seeds is not None:
                    gen = torch.Generator(device=ori_o.device).manual_seed(seeds[c])
                out = _manipulate(cfg, query_fn, prepared, (ori_o_p[s], _guard(ori_d_p[s])),
                                  [(tar_o_p[k, s], _guard(tar_d_p[k, s]))
                                   for k in range(n_targets)],
                                  move_labels, generator=gen)
                outs.append({k: out[k] for k in ("rgb", "ins", "tar_rgb")})
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    graph: Optional[_ChunkGraph] = None

    @torch.no_grad()
    def run(params_coarse, params_fine, ori_o, ori_d, tar_o, tar_d, move_labels,
            generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        nonlocal graph
        if ori_o.device.type != "cuda":
            return run_eager(params_coarse, params_fine, ori_o, ori_d, tar_o, tar_d,
                             move_labels, generator)
        with torch.cuda.device(ori_o.device):
            prepared = _prepare(query_fn, params_coarse, params_fine, rgb_stub=True)
            if graph is None:
                graph = _ChunkGraph(cfg, query_fn, prepared, n_targets, ori_o)
            n = ori_o.shape[0]
            seeds = chunk_seeds(generator, -(-n // chunk))
            return graph(prepared, ori_o, ori_d, tar_o, tar_d, move_labels, seeds)

    run.eager = run_eager
    return run


def draw_ahead(u: torch.Tensor, generator: torch.Generator) -> None:
    """A chunk's K+2 importance draws into ``u`` [K+2, n, N_importance], in the order
    ``_manipulate`` draws them from ``generator``: the original's pass 1, each target's,
    then the original's pass 2. Each row equals that draw bit for bit (``torch.rand`` is
    ``uniform_`` on a fresh tensor)."""
    for row in u:
        row.uniform_(generator=generator)


def _guard(d):
    """Padding rays get d = 1, not 0/0 viewdirs."""
    return torch.where(torch.sum(d * d, -1, keepdim=True) > 0, d, torch.ones_like(d))


class _ChunkGraph:
    """One chunk of a manipulated render, the whole of ``_manipulate`` for K targets,
    captured as one CUDA graph on the current device (the module docstring);
    ``graph(prepared, ori_o, ori_d, tar_o, tar_d, move_labels, seeds)`` renders all the
    rays by its replays. It serves rays of the device and dtype it was captured for,
    parameters of the same shapes and K move labels: others raise."""

    def __init__(self, cfg: Config, query_fn: QueryFn, prepared, n_targets: int,
                 like: torch.Tensor):
        # every tensor the graph reads is held here: a freed one's memory would be reused
        self.prepared = tuple(static_params(p) for p in prepared)
        self.K, chunk = n_targets, cfg.N_test
        dev, dtype = like.device, like.dtype
        self.rays = torch.zeros((1 + n_targets, chunk, 6), dtype=dtype, device=dev)
        self.u = torch.zeros((n_targets + 2, chunk, cfg.N_importance), dtype=dtype, device=dev)
        self.labels = torch.zeros((n_targets,), dtype=torch.int64, device=dev)
        self.linspace = torch.linspace(0.0, 1.0, cfg.N_importance, dtype=dtype, device=dev)

        def chunk_maps():
            o, d = self.rays[..., :3], _guard(self.rays[..., 3:])
            out = _manipulate(cfg, query_fn, self.prepared, (o[0], d[0]),
                              [(o[1 + k], d[1 + k]) for k in range(n_targets)],
                              self.labels, u=self.u)
            return torch.cat([out["rgb"], out["ins"], out["tar_rgb"]], -1), out["rgb"].shape[-1]

        self.graph, (self.maps, self.n_rgb) = capture_graph(torch.cuda.Stream(), chunk_maps,
                                                            chunk_maps)

    def __call__(self, prepared, ori_o, ori_d, tar_o, tar_d, move_labels,
                 seeds: Optional[List[int]]) -> Dict[str, torch.Tensor]:
        want = f"{self.rays.dtype} on {self.rays.device}"
        took = {f"{x.dtype} on {x.device}" for x in (ori_o, ori_d, tar_o, tar_d)}
        if took != {want}:
            raise ValueError(f"the manipulator's chunk graph takes rays of {want}, not "
                             f"{', '.join(sorted(took))}: make a renderer for each")
        if tar_o.shape[0] != self.K:
            raise ValueError(f"renderer built for {self.K} targets, got {tar_o.shape[0]}")
        if len(move_labels) != self.K:
            raise ValueError(f"{self.K} target bundles for {len(move_labels)} move labels")
        for static, p in zip(self.prepared, prepared):
            copy_params(static, p)
        self.labels.copy_(torch.as_tensor(move_labels, dtype=torch.int64))
        if seeds is None:
            self.u.copy_(self.linspace.expand_as(self.u))
        n, chunk = ori_o.shape[0], self.rays.shape[1]
        rays = torch.cat([torch.cat([ori_o, ori_d], -1)[None], torch.cat([tar_o, tar_d], -1)])
        out = torch.empty((n + (-n) % chunk, self.maps.shape[-1]), dtype=self.maps.dtype,
                          device=self.maps.device)
        for c, c0 in enumerate(range(0, n, chunk)):
            m = min(chunk, n - c0)
            with span("mani.chunk", m):
                if seeds is not None:
                    draw_ahead(self.u, torch.Generator(device=self.u.device).manual_seed(seeds[c]))
                self.rays[:, :m].copy_(rays[:, c0:c0 + m])
                if m < chunk:
                    self.rays[:, m:].zero_()
                self.graph.replay()
                out[c0:c0 + chunk].copy_(self.maps)
        r, w = self.n_rgb, self.maps.shape[-1]
        return {"rgb": out[:n, :r].contiguous(), "ins": out[:n, r:w - r].contiguous(),
                "tar_rgb": out[:n, w - r:].contiguous()}


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
