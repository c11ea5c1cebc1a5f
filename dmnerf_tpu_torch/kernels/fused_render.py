"""The fused render passes: the point query and the volume compositing of a chunk of rays
in one launch (K8c, K8f, ``csrc/fused_render.cu``), their plain PyTorch version, the
wrapper that picks between them and the host plan of the kernel's walk. They replace the
Pallas TPU kernel of ``scripts/dev/fused_render_probe.py`` (``_render_kernel`` :62,
``pallas_call`` :142), a probe the JAX package measured and never wired into its
renderer.

For rays o, d [N, 3] and sorted depths z [N, S] a pass computes, per ray,

    points  o + d * z (d = 1 where the ray's direction is zero, as the image renderer
            pads), viewdirs d / |d|; raw = fused_query(points, viewdirs)
    dists   = (z[s+1] - z[s], 1e10 at the last sample) * |d|
    alpha   = 1 - exp(-relu(sigma) * dists)
    w       = alpha * exp(exclusive cumsum of log(max(1 - alpha, 1e-10)))

and returns the weights [N, S] (``weights_only``, the coarse pass: sample_pdf needs no
more) or the maps [N, 4 + C] = [sum w sigmoid(rgb) | sum w z | sigmoid(sum w logits)]
with the air channel kept (the fine pass): ``core.compositor.composite`` and
``composite_maps(keep_air=True)`` over ``fused_query``'s raw. raw itself stays on the
SM. K8c reads the layer table only up to sigma, which is all the weights need.

The kernel is K1's template (``csrc/fused_mlp_fwd.cuh`` with its CMP epilogue), so it
takes the packed layout of ``kernels.fused_mlp`` and its products are K1's; the walk
follows rays (``_render_plan``). K8f's entry takes the schedule of the template's
consumers' products (lockstep or pipelined, the same bits); its path takes pipelined
(``MAPS_SCHEDULE``). K8c's source builds lockstep, as K1's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from dmnerf_tpu_torch.core.compositor import _weights, composite_maps
from dmnerf_tpu_torch.kernels import runtime
from dmnerf_tpu_torch.kernels.fused_mlp import (
    LOCKSTEP, PIPELINED, Packed, _check_device_inputs, _check_kernel_inputs, _fwd_plan,
    query_fwd, view_embedding)

_TILE = 128        # points a tile (csrc/fused_mlp_fwd.cuh FT)
_CMP_PITCH = 53    # the staged output columns a row hold (csrc/fused_mlp_fwd.cuh CMP_PITCH)
_ENTRY = {True: "fused_render_weights", False: "fused_render_maps"}
# K8f's schedule of the consumers' products on its path (fused_mlp.PIPELINED; its entry
# also takes LOCKSTEP, the bit reference); K8c's entry takes none, its source builds lockstep
MAPS_SCHEDULE = PIPELINED


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _fix_dirs(rays_d: torch.Tensor) -> torch.Tensor:
    """Rays with a zero direction (the renderers' padding) get d = 1, not 0/0 viewdirs."""
    return torch.where(torch.sum(rays_d * rays_d, -1, keepdim=True) > 0, rays_d,
                       torch.ones_like(rays_d))


def fused_render_ref(packed: Packed, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     z: torch.Tensor, weights_only: bool,
                     act_dtype=torch.float32) -> torch.Tensor:
    """K8c's (``weights_only``) or K8f's function in torch ops: rays_o, rays_d [N, 3], z
    [N, S] -> weights [N, S] or maps [N, 4 + C] fp32. The query is K1's plain version
    (``query_fwd``) with its roundings per ``act_dtype``; the compositing is the
    compositor's, fp32."""
    d = _fix_dirs(rays_d)
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    pts = rays_o[..., None, :] + d[..., None, :] * z[..., :, None]
    raw = query_fwd(packed, pts, viewdirs, "kernel_t", act_dtype)
    if weights_only:
        return _weights(raw, z, d)
    rgb, ins, depth = composite_maps(raw, z, d, keep_air=True)
    return torch.cat([rgb, depth[:, None], ins], dim=-1)


# ---------------------------------------------------------------------------
# The host plan of the walk
# ---------------------------------------------------------------------------

def _render_plan(N: int, S: int) -> Dict[str, int]:
    """The ray-aligned walk of csrc/fused_render.cu for N rays of S samples (point p =
    ray * S + sample): ``tiles`` of 128 points, grouped into ``spans`` of ``span``
    tiles that hold ``rays_per_span`` whole rays (span * 128 = lcm(S, 128)). The kernel
    takes ``span``: a block walks the tiles of a span in order, so a ray lies in one
    block and its compositing carries from tile to tile; the two blocks of a cluster
    take spans 2 q and 2 q + 1 of each pair q it walks."""
    if N <= 0 or S <= 0:
        raise ValueError(f"want N, S > 0, got {N}, {S}")
    points = math.lcm(S, _TILE)
    tiles = -(-N * S // _TILE)
    span = points // _TILE
    return dict(tile=_TILE, span=span, rays_per_span=points // S, tiles=tiles,
                spans=-(-tiles // span))


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def ray_table(packed: Packed, rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, edr) of a batch of rays: the directions with the padding's zero rows set to 1,
    and the per-ray viewdir embedding [N, EDP] in bf16 that the kernel reads (K1's).
    A renderer builds it once per view and hands slices of it to both passes."""
    d = _fix_dirs(rays_d).contiguous()
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return d, view_embedding(packed, viewdirs).to(torch.bfloat16).contiguous()


def _sigma_table(packed: Packed) -> Packed:
    """The packed layer table cut after sigma: all the weights pass reads."""
    kinds = [layer.kind for layer in packed.layers]
    return dataclasses.replace(packed, layers=packed.layers[:kinds.index("sigma") + 1])


def _check_render_inputs(packed: Packed, rays_o, d, z, edr, weights_only: bool) -> None:
    name = _ENTRY[weights_only]
    _check_kernel_inputs(name, packed, rays_o, d, ("rays_o", "rays_d"))
    _check_device_inputs(name, (("z", z, torch.float32), ("edr", edr, torch.bfloat16)))
    N = rays_o.shape[0]
    if rays_o.shape != (N, 3) or d.shape != (N, 3) or z.dim() != 2 or z.shape[0] != N \
            or z.shape[1] == 0 or edr.shape != (N, packed.edp):
        raise ValueError(f"want rays_o, rays_d [N, 3], z [N, S], edr [N, {packed.edp}], got "
                         f"{tuple(rays_o.shape)}, {tuple(d.shape)}, {tuple(z.shape)}, "
                         f"{tuple(edr.shape)}")
    if N * z.shape[1] > (1 << 31) - _TILE:
        raise ValueError(f"fused render takes fewer than 2^31 points, got {N * z.shape[1]}")
    if not weights_only and packed.c4 > _CMP_PITCH:
        raise ValueError(f"fused render stages at most {_CMP_PITCH} output columns "
                         f"(ins_num <= {_CMP_PITCH - 5}), got {packed.c4}")


def _launch_render(packed: Packed, rays_o: torch.Tensor, d: torch.Tensor, z: torch.Tensor,
                   edr: torch.Tensor, weights_only: bool,
                   schedule: Optional[int] = None) -> torch.Tensor:
    """One launch of K8c (``weights_only``) or K8f over checked inputs. K8f's consumers
    run under ``schedule`` (default ``MAPS_SCHEDULE``); K8c takes none."""
    name = _ENTRY[weights_only]
    if not weights_only:
        schedule = MAPS_SCHEDULE if schedule is None else schedule
    if schedule not in ((None,) if weights_only else (LOCKSTEP, PIPELINED)):
        raise ValueError(f"{name} takes no schedule {schedule}")
    N, S = z.shape
    out = torch.empty((N, S) if weights_only else (N, packed.c4), dtype=torch.float32,
                      device=z.device)
    plan = _render_plan(N, S)
    table = _fwd_plan(_sigma_table(packed) if weights_only else packed)["table"]
    c_table = (ctypes.c_longlong * len(table))(*table)
    fn = getattr(runtime.load("fused_render"), f"dmnerf_{name}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] \
        + ([] if weights_only else [ctypes.c_int])
    fn.restype = ctypes.c_int
    dev = z.device
    err = fn(rays_o.data_ptr(), d.data_ptr(), z.data_ptr(), edr.data_ptr(),
             packed.wt_bf16.data_ptr(), packed.b.data_ptr(), out.data_ptr(), N, S, plan["span"],
             ctypes.addressof(c_table), torch.cuda.get_device_properties(dev).multi_processor_count,
             torch.cuda.current_stream(dev).cuda_stream, *(() if weights_only else (schedule,)))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err} (a cudaError, or 10000 + the "
                           f"CUresult of the tensor-map encoder)")
    runtime.count_launch(name)
    return out


def fused_render(packed: Packed, rays_o: torch.Tensor, rays_d: torch.Tensor, z: torch.Tensor,
                 weights_only: bool, table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The weights [N, S] (``weights_only``: K8c) or the maps [N, 4 + C] (K8f) of rays
    rays_o, rays_d [N, 3] sampled at z [N, S]. CUDA tensors go through the Hopper kernel,
    CPU tensors through ``fused_render_ref`` in fp32; there is no fallback from one to
    the other. ``table`` is ``ray_table(packed, rays_d)`` where the caller has it (a
    renderer builds it once per view); on the card it is built here otherwise."""
    if z.device.type == "cpu":
        return fused_render_ref(packed, rays_o, rays_d, z, weights_only)
    d, edr = ray_table(packed, rays_d) if table is None else table
    z = z.contiguous()
    _check_render_inputs(packed, rays_o, d, z, edr, weights_only)
    if rays_o.shape[0] == 0:
        return torch.empty((0, z.shape[1]) if weights_only else (0, packed.c4),
                           dtype=torch.float32, device=z.device)
    return _launch_render(packed, rays_o, d, z, edr, weights_only)
