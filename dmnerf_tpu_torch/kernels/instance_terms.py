"""K12: a training bundle's instance channels, forward and backward, its plain PyTorch
version and its wrapper.

What a training step does with raw[..., 4:] of a bundle (coarse or fine): the instance
map's weighted sum over the samples, with the compositing weights detached
(``core.compositor.composite``), and the emptiness penalizer's four sums
(``objfield.penalizer.penalizer_sums``, a row of four a ray), with depth detached. In
PyTorch that was about thirty passes over [N, S, C'] tensors, forward and backward;
``csrc/instance_terms.cu`` does it in one forward and one backward launch that read raw's
instance columns once each and write the logits, the sums and raw's cotangent once (the
source's head says how). The caller keeps the [N, C'] and smaller work: the sigmoid, dropping the air
column, the sum of the rays' sums, the ranks' sum of those (``reduce_sums``) and the two
ratios (``penalizer.penalty``).

``instance_terms`` routes: a CPU tensor gets the plain version, a CUDA tensor the kernels
(``_InstanceTerms``, an autograd function whose backward is the second kernel) or an
error. ``instance_terms_fwd`` / ``instance_terms_bwd`` are the two launches, each counted
in ``runtime.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from dmnerf_tpu_torch.kernels import runtime
from dmnerf_tpu_torch.objfield.penalizer import penalizer_sums

THREADS = 256      # csrc/instance_terms.cu: a row of 4 + C' columns in one block
MAX_S = 16384      # samples a ray: three [S] arrays of shared memory


def instance_terms_ref(raw, weights, z_vals, depth, rays_d, tolerance: float, deta_w: float,
                       penalize: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K12's function in PyTorch, the operations the step ran before K12: (ins_logits
    [N, C'], the penalizer's sums of each ray [N, 4] or None without ``penalize``)."""
    logits = torch.sum(weights.detach()[..., None] * raw[..., 4:], dim=-2)
    sums = penalizer_sums(raw, z_vals, depth, rays_d, tolerance, deta_w) if penalize else None
    return logits, sums


def _scalars(tolerance: float, deta_w: float):
    """The kernel's fp32 scalars: the tolerance, and the reciprocals PyTorch multiplies by
    on the card where the plain version divides by a Python scalar."""
    one = np.float32(1.0)
    return (float(np.float32(tolerance)), float(one / np.float32(2.0 * deta_w ** 2)),
            float(one / np.float32(0.4 * math.sqrt(2.0 * math.pi))))


def _check(raw, w, z, depth, norm) -> None:
    if raw.dim() != 3 or not 5 <= raw.shape[-1] <= THREADS or not 1 <= raw.shape[1] <= MAX_S:
        raise ValueError(f"instance_terms wants raw [N, S <= {MAX_S}, 4 + C'] with 1 <= C' <= "
                         f"{THREADS - 4}, got {tuple(raw.shape)}")
    N, S = raw.shape[:2]
    for what, t, shape in (("raw", raw, tuple(raw.shape)), ("weights", w, (N, S)),
                           ("z_vals", z, (N, S)), ("depth", depth, (N,)), ("norm", norm, (N,))):
        if t.device != raw.device or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: want a contiguous float32 {list(shape)} tensor on "
                             f"{raw.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if torch.cuda.get_device_capability(raw.device) != (9, 0):
        raise RuntimeError(f"instance_terms is built for sm_90a; device {raw.device} is not "
                           "capability 9.0")


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def instance_terms_fwd(raw, w, z, depth, norm, tolerance: float, deta_w: float,
                       penalize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K12's forward on the current stream: raw [N, S, 4 + C'], weights and
    z [N, S], depth and the rays' norms [N] (fp32, contiguous, on the card) -> (logits
    [N, C'], the rays' sums [N, 4]; the sums are not written without ``penalize``). No host
    read, so it
    can be captured in a CUDA graph."""
    _check(raw, w, z, depth, norm)
    N, S, R = raw.shape
    dev = raw.device
    logits = torch.empty((N, R - 4), dtype=torch.float32, device=dev)
    sums = torch.empty((N, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _raise(_lib().dmnerf_instance_terms_fwd(
            raw.data_ptr(), w.data_ptr(), z.data_ptr(), depth.data_ptr(), norm.data_ptr(), N, S,
            R - 4, int(penalize), *_scalars(tolerance, deta_w), logits.data_ptr(),
            sums.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "instance_terms forward")
    runtime.count_launch("instance_terms_fwd")
    return logits, sums


def instance_terms_bwd(raw, w, z, depth, norm, g_logits, g_sums, tolerance: float,
                       deta_w: float, penalize: bool) -> torch.Tensor:
    """One launch of K12's backward: the forward's inputs, the cotangents of its logits
    [N, C'] and of its sums [N, 4] (the counts' are not read) -> d_raw [N, S, 4 + C'], zero in
    the first four columns."""
    _check(raw, w, z, depth, norm)
    N, S, R = raw.shape
    dev = raw.device
    for what, t, shape in (("g_logits", g_logits, (N, R - 4)), ("g_sums", g_sums, (N, 4))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: want a contiguous float32 {list(shape)} tensor on {dev}")
    d_raw = torch.empty_like(raw)
    with torch.cuda.device(dev):
        _raise(_lib().dmnerf_instance_terms_bwd(
            raw.data_ptr(), w.data_ptr(), z.data_ptr(), depth.data_ptr(), norm.data_ptr(),
            g_logits.data_ptr(), g_sums.data_ptr(), N, S, R - 4, int(penalize),
            *_scalars(tolerance, deta_w), d_raw.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "instance_terms backward")
    runtime.count_launch("instance_terms_bwd")
    return d_raw


class _InstanceTerms(torch.autograd.Function):
    """(logits, sums) = K12 forward of raw; the backward is K12's backward, for raw alone
    (the weights and depth are detached, z and the norms take no gradient)."""

    @staticmethod
    def forward(ctx, raw, w, z, depth, norm, tolerance, deta_w, penalize):
        ctx.args = (tolerance, deta_w, penalize)
        ctx.save_for_backward(raw, w, z, depth, norm)
        return instance_terms_fwd(raw, w, z, depth, norm, tolerance, deta_w, penalize)

    @staticmethod
    def backward(ctx, g_logits, g_sums):
        d_raw = instance_terms_bwd(*ctx.saved_tensors, g_logits.contiguous(),
                                   g_sums.contiguous(), *ctx.args)
        return d_raw, None, None, None, None, None, None, None


def instance_terms(raw: torch.Tensor, weights: torch.Tensor, z_vals: torch.Tensor,
                   depth: torch.Tensor, rays_d: torch.Tensor, tolerance: float, deta_w: float,
                   penalize: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A bundle's instance terms: raw [N, S, 4 + C'], its compositing weights and z_vals
    [N, S], its depth [N] and rays_d [N, 3] -> (ins_logits [N, C'] = sum_s w raw[..., 4:]
    with the weights detached, and with ``penalize`` the penalizer's sums of each ray
    [N, 4] of ``penalizer_sums``, else None). Differentiable in raw. CUDA tensors go through K12,
    CPU tensors through ``instance_terms_ref``; there is no fallback from one to the
    other."""
    if raw.device.type != "cuda":
        return instance_terms_ref(raw, weights, z_vals, depth, rays_d, tolerance, deta_w,
                                  penalize)
    # the norms as the plain version takes them, so the masks are its own
    norm = torch.linalg.norm(rays_d.detach(), dim=-1)
    logits, sums = _InstanceTerms.apply(raw, weights.detach().contiguous(),
                                        z_vals.detach().contiguous(),
                                        depth.detach().contiguous(), norm, float(tolerance),
                                        float(deta_w), bool(penalize))
    return logits, sums if penalize else None


def _lib() -> ctypes.CDLL:
    lib = runtime.load("instance_terms")
    if not getattr(lib, "typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dmnerf_instance_terms_fwd.argtypes = [ptr] * 5 + [i32] * 4 + [f32] * 3 + [ptr] * 3
        lib.dmnerf_instance_terms_bwd.argtypes = [ptr] * 7 + [i32] * 4 + [f32] * 3 + [ptr] * 2
        for fn in (lib.dmnerf_instance_terms_fwd, lib.dmnerf_instance_terms_bwd):
            fn.restype = ctypes.c_int
        lib.typed = True
    return lib
