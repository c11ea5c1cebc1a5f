"""The two head probes of the JAX package on Hopper: their kernels (K9 ``head512``, K10
``heads_fused``; ``csrc/head512.cu``, ``csrc/heads_fused.cu``), their plain PyTorch
versions, the carriers from the probes' arrays to the kernels' layout and the wrappers.

K9 replaces the Pallas TPU kernel of ``scripts/dev/head512_probe.py`` (``kernel`` :53,
``pallas_call`` :83): an 8-layer bias-free ReLU trunk of [W, W] over x [P, W] bf16, the
activations rounded to bf16, then a head that is every column computed and 32 stored:

    a  head [W, 513]                           out = head[:, :32]
    b  head [W, 512] + sigma = h . wd (fp32)   out = [head[:, :31] | sigma]
    c  head [W, 512]                           out = head[:, :32]
    d  head [W, 512] + sigma as its own n16 product (the port's layout), out as b

K10 replaces ``scripts/dev/mfu_probe4.py``'s ``k_headsnew`` (:63, ``pallas_call`` :79),
the fused head over h [P, W] bf16 and the transposed viewdir embedding edT [27, P] bf16:

    pre1 = h @ M1 + b1                         M1 [W, 2H + 1] = [Wrf.Wrh1 | Wif.Wih | Wd]
    rh   = bf16(relu(pre1[:, :H] + edT^T @ Wrh2)),   ih = bf16(relu(pre1[:, H:2H]))
    o    = [rh | ih] @ M2 + b2                 M2 [2H, 3 + C] block-diagonal
    out  = row sum of [o[:, :3] | pre1[:, 2H] | o[:, 3:]]   [P, 1]

and ``split`` computes o as rh @ Wro and ih @ Wio, the form the JAX package landed
(``dmnerf_tpu/kernels/fused_mlp.py:426-429``). Each probe asks a question of the port's
forward template (``csrc/fused_mlp_fwd.cuh``), so both kernels are that template over a
layer table of their own: K9 whether a CUDA-core sigma dot beats the n16 sigma layer,
K10 whether two output products beat the block-diagonal one.

K10's entry takes the schedule of the template's consumers' products as an argument
(lockstep or pipelined, the same bits); its path takes pipelined
(``HEADS_FUSED_SCHEDULE``). K9's source builds lockstep, as K1's.

The kernels read x or h [P, W] through TMA into the template's swizzled tiles and
their consumers take it into the registers that hold every hidden activation; edT is
transposed into a swizzled ed tile by the embedding warps. ``store_all`` (tests only)
writes every head column (K9: [P, 512 or 513], sigma last for b and d) or the [P, 4 + C]
columns before K10's row sum, to show that no column was skipped.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from dmnerf_tpu_torch.kernels import runtime
from dmnerf_tpu_torch.kernels.fused_mlp import (
    _FWD_BOX_K, LOCKSTEP, PIPELINED, _check_device_inputs, _pack, _round_up, _rounder)

H512_MODES = ("a", "b", "c", "d")
H512_OUT = 32                # columns the probe stores
H512_SIGMA_COL = 31          # sigma's column in modes b and d
WIDTH = 256                  # the width both kernels hold (x / h is four 64-column tiles)
# csrc/fused_mlp_fwd.cuh: a layer's A segments (Seg), epilogues (Epilogue) and what the
# head-probe walk writes (HeadOut)
_PSEG = {"ed": 1, "h": 4, "h_lo": 16, "h_hi": 32}
_PEPI = {"relu": 0, "sigma": 1, "cols": 3, "dot": 4}
_OUT_COLS, _OUT_ROWSUM = 0, 1
# K10's schedule of the consumers' products on its path (fused_mlp.PIPELINED; its entry
# also takes LOCKSTEP, the bit reference); K9's entry takes none, its source builds lockstep
HEADS_FUSED_SCHEDULE = PIPELINED


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _check_head512(mode: str, x: torch.Tensor, ws: Sequence[torch.Tensor], wd) -> None:
    if mode not in H512_MODES:
        raise ValueError(f"mode must be one of {H512_MODES}, got {mode!r}")
    if x.dim() != 2 or len(ws) < 2:
        raise ValueError(f"want x [P, W] and at least one trunk layer and the head, got x "
                         f"{tuple(x.shape)} and {len(ws)} weights")
    W = x.shape[1]
    heads = 2 * W + (mode == "a")
    if any(tuple(w.shape) != (W, W) for w in ws[:-1]) or tuple(ws[-1].shape) != (W, heads):
        raise ValueError(f"mode {mode}: want trunk weights [{W}, {W}] and a head [{W}, {heads}], "
                         f"got {[tuple(w.shape) for w in ws]}")
    if (mode in "bd") != (wd is not None) or (wd is not None and tuple(wd.shape) != (1, W)):
        raise ValueError(f"mode {mode}: want wd [1, {W}] for b and d and none otherwise, got "
                         f"{None if wd is None else tuple(wd.shape)}")
    if heads < H512_OUT:
        raise ValueError(f"the head must hold the {H512_OUT} stored columns, got {heads}")


def head512_ref(mode: str, x: torch.Tensor, ws: Sequence[torch.Tensor],
                wd: Optional[torch.Tensor] = None, act_dtype=torch.bfloat16,
                store_all: bool = False, sum_dtype=torch.float32) -> torch.Tensor:
    """K9's function in torch ops: x [P, W], the trunk weights ``ws[:-1]`` [W, W] and the
    head ``ws[-1]`` [W, 2W (+1 in mode a)], wd [1, W] in modes b and d -> [P, 32] fp32
    (``store_all``: the whole head, then sigma in b and d). Products are fp32 over the
    given values; ``act_dtype`` bf16 rounds each trunk ReLU output as the probe does
    (``head512_probe.py:58``), fp32 rounds nothing. ``sum_dtype`` float64 takes each
    product's sums exactly rounded to fp32 (another order of sums than PyTorch's fp32
    matmul, whose distance to it is the floor a kernel's own order is held to). Mode d
    is b's function (the kernels differ in how they take sigma)."""
    _check_head512(mode, x, ws, wd)
    rnd = _rounder(act_dtype)
    mm = lambda a, w: (a.to(sum_dtype) @ w.to(sum_dtype)).float()   # noqa: E731
    h = x.float()
    for w in ws[:-1]:
        h = rnd(torch.relu(mm(h, w)))
    head = mm(h, ws[-1])
    sigma = None if wd is None else mm(h, wd.t())
    if store_all:
        return head if sigma is None else torch.cat([head, sigma], dim=1)
    if sigma is None:
        return head[:, :H512_OUT]
    return torch.cat([head[:, :H512_SIGMA_COL], sigma], dim=1)


def _check_heads(h, edT, m1, b1, wrh2, m2, b2) -> Tuple[int, int]:
    W = h.shape[-1]
    H, C = (m1.shape[-1] - 1) // 2, m2.shape[-1] - 3
    P = h.shape[0]
    if h.dim() != 2 or edT.dim() != 2 or edT.shape[1] != P or tuple(m1.shape) != (W, 2 * H + 1) \
            or b1.numel() != 2 * H + 1 or tuple(wrh2.shape) != (edT.shape[0], H) \
            or tuple(m2.shape) != (2 * H, 3 + C) or b2.numel() != 3 + C or C < 1:
        raise ValueError(f"want h [P, W], edT [E, P], M1 [W, 2H+1], b1 [2H+1], Wrh2 [E, H], "
                         f"M2 [2H, 3+C], b2 [3+C]; got {[tuple(t.shape) for t in (h, edT, m1, b1, wrh2, m2, b2)]}")
    return H, C


def heads_fused_ref(h: torch.Tensor, edT: torch.Tensor, m1: torch.Tensor, b1: torch.Tensor,
                    wrh2: torch.Tensor, m2: torch.Tensor, b2: torch.Tensor, split: bool = False,
                    act_dtype=torch.bfloat16,
                    sum_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's function in torch ops, in the probe's order of operations: returns the row
    sum [P, 1] the probe writes and the columns [P, 4 + C] = [o[:, :3] | sigma | o[:, 3:]]
    before it, fp32. ``split`` takes o as rh @ M2[:H, :3] and ih @ M2[H:, 3:] (the rgb and
    ins output weights, which are M2's diagonal blocks). ``act_dtype`` bf16 rounds M1,
    Wrh2, M2, rh and ih as the probe does (``mfu_probe4.py:51,69-70``); fp32 rounds
    nothing. The biases are fp32 either way. ``sum_dtype`` as ``head512_ref``'s."""
    H, _ = _check_heads(h, edT, m1, b1, wrh2, m2, b2)
    rnd = _rounder(act_dtype)
    mm = lambda a, w: (a.to(sum_dtype) @ w.to(sum_dtype)).float()   # noqa: E731
    m1, wrh2, m2 = (rnd(t.float()) for t in (m1, wrh2, m2))
    pre1 = mm(h.float(), m1) + b1.float().reshape(1, -1)
    edc = mm(edT.float().t(), wrh2)
    rh = rnd(torch.relu(pre1[:, :H] + edc))
    ih = rnd(torch.relu(pre1[:, H:2 * H]))
    sigma = pre1[:, 2 * H:]
    if split:
        o = torch.cat([mm(rh, m2[:H, :3]), mm(ih, m2[H:, 3:])], dim=-1) + b2.float().reshape(1, -1)
    else:
        o = mm(torch.cat([rh, ih], dim=-1), m2) + b2.float().reshape(1, -1)
    cols = torch.cat([o[:, :3], sigma, o[:, 3:]], dim=-1)
    return torch.sum(cols.to(sum_dtype), dim=1, keepdim=True).float(), cols


def compare(got: torch.Tensor, ref32: torch.Tensor, ref16: torch.Tensor,
            ref16_exact: torch.Tensor, tol: float = 5e-3) -> dict:
    """A kernel's output against its plain versions: fp32 (``ref32``), bf16 with
    PyTorch's fp32 sums (``ref16``) and bf16 with exact sums (``ref16_exact``,
    ``sum_dtype=torch.float64``). The bars: max|got - ref32| <= tol * max(scale, 1)
    (``bench.py:363``), and max|got - ref16_exact| <= tol * scale or, where the function's
    own order floor is above that, twice the floor: max|ref16 - ref16_exact|, how far
    PyTorch's fp32 matmul order lands from exact sums under the same bf16 roundings (an
    activation whose rounding flips under another order carries through the later
    layers). ``ok`` is both."""
    scale = float(ref32.abs().max())
    floor = float((ref16 - ref16_exact).abs().max())
    r = dict(out_scale=scale, max_abs_err=float((got - ref32).abs().max()),
             max_abs_err_bf16_plain=float((got - ref16).abs().max()),
             max_abs_err_bf16_exact=float((got - ref16_exact).abs().max()),
             order_floor=floor, bf16_bar=max(tol * scale, 2 * floor))
    r["ok"] = bool(got.shape == ref32.shape and torch.isfinite(got).all()
                   and r["max_abs_err"] <= tol * max(scale, 1.0)
                   and r["max_abs_err_bf16_exact"] <= r["bf16_bar"])
    return r


def heads_operands(params: dict, multires_views: int) -> dict:
    """K10's operands from a DM-NeRF parameter dict through the port's ``_pack``
    (``kernels/fused_mlp.py``), fp32: M1 [W, 2H+1], b1 [2H+1], Wrh2 [27, H] (rows in
    kernel lane order), M2 [2H, 3 + C] block-diagonal with [Wro ; Wio] on its diagonal
    (``mfu_probe4.py:54-57``; its diagonal blocks, which the split variant reads, are
    ``rgb_out_w`` and ``ins_out_w`` as ``_pack`` gives them) and b2 [3 + C]. The trunk is
    not read: ``_pack`` is asked for one layer."""
    multires = (params["trunk_0_w"].shape[0] // 3 - 1) // 2
    flat = _pack(params, multires, multires_views, 1, ())
    m1, b1, wrh2, _, wro, bro, wio, bio = flat[2:]
    Hr, Hi = wro.shape[0], wio.shape[0]
    if Hr != Hi:
        raise ValueError(f"the probe's M2 wants equal rgb and ins hidden widths, got {Hr}, {Hi}")
    m2 = torch.zeros((Hr + Hi, 3 + wio.shape[1]), dtype=m1.dtype, device=m1.device)
    m2[:Hr, :3] = wro
    m2[Hr:, 3:] = wio
    return dict(m1=m1, b1=b1.reshape(-1), wrh2=wrh2, m2=m2,
                b2=torch.cat([bro.reshape(-1), bio.reshape(-1)]))


# ---------------------------------------------------------------------------
# The kernels' layout: a layer table of the forward template
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProbeLayer:
    epi: str          # relu (into h) | sigma (n16 product, column 0) | dot (CUDA cores) | cols
    segs: Tuple[Tuple[str, int, int], ...]   # (source, first K row, rows): ed, h, h_lo, h_hi
    N: int            # rows of its transposed block (a multiple of 16)
    K: int            # columns of its transposed block
    w_off: int        # offset of the block [N, K] in ProbeOperands.wt
    b_off: int        # offset of its N biases (dot: the W weights of its row) in .b
    o_col: int        # first output column (or row-sum slot) its columns go to
    o_n: int          # its columns that are written or summed (sigma, dot: 0 or 1)
    sig_col: int      # the column of its own that takes sigma instead, or -1


@dataclasses.dataclass(frozen=True)
class ProbeOperands:
    """A head probe's weights and table in the kernel's layout: each weight block
    transposed to [N, K] (K-major, as ``Packed.wt_bf16``) and padded to N % 16 == 0 with
    zero rows, bf16, 128-byte aligned; fp32 biases."""
    wt: torch.Tensor
    b: torch.Tensor
    layers: Tuple[ProbeLayer, ...]
    rowsum: bool      # write the row sum [P, 1] instead of columns [P, o_pitch]
    o_pitch: int
    edp: int          # columns of the ed tile the head reads (0: no edT)


def _carry(entries, rowsum: bool, o_pitch: int, edp: int = 0) -> ProbeOperands:
    """``entries`` (epi, segs, w [K, N] or None, bias [N] or the dot's row [W], o_col,
    o_n, sig_col) -> ProbeOperands, every block transposed to [N_pad, K] in bf16."""
    layers, ws, bs = [], [], []
    w_off = b_off = 0
    for epi, segs, w, b, o_col, o_n, sig_col in entries:
        b = b.detach().float().reshape(-1)
        if w is None:
            K = N = 0
        else:
            K, n = w.shape
            N = _round_up(n, 16)
            wt = torch.zeros((N, K), dtype=torch.float32, device=w.device)
            wt[:n] = w.detach().float().t()
            pad = _round_up(N * K, 64) - N * K          # the next block 128-byte aligned
            ws += [wt.reshape(-1), torch.zeros(pad, device=w.device)]
            b = torch.cat([b, torch.zeros(N - b.numel(), device=b.device)])
        layers.append(ProbeLayer(epi, tuple(segs), N, K, w_off, b_off, o_col, o_n, sig_col))
        bs.append(b)
        w_off += 0 if w is None else _round_up(N * K, 64)
        b_off += b.numel()
    return ProbeOperands(wt=torch.cat(ws).to(torch.bfloat16), b=torch.cat(bs),
                         layers=tuple(layers), rowsum=rowsum, o_pitch=o_pitch, edp=edp)


def head512_operands(mode: str, ws: Sequence[torch.Tensor], wd: Optional[torch.Tensor] = None,
                     store_all: bool = False) -> ProbeOperands:
    """K9's table: the trunk (ReLU layers, zero biases), then in mode d the sigma layer
    ([W, 16], column 0 = wd) and in mode b the CUDA-core dot with wd, then the head as
    passes of at most 256 columns over the same h (two; mode a a third of one column,
    padded to an n16 pass). Without ``store_all`` the first pass writes columns 0..31
    (31 taking sigma in b and d) and the others nothing; with it every column is written,
    sigma last."""
    W = ws[0].shape[0]
    dev = ws[0].device
    zeros = lambda n: torch.zeros(n, device=dev)   # noqa: E731
    h = (("h", 0, W),)
    entries = [("relu", h, w, zeros(W), 0, 0, -1) for w in ws[:-1]]
    head = ws[-1]
    n_head = head.shape[1]
    sig_at = n_head if store_all else -1
    if mode == "d":
        entries.append(("sigma", h, wd.t(), zeros(1), sig_at, int(store_all), -1))
    elif mode == "b":
        entries.append(("dot", (), None, wd.float().reshape(-1), sig_at, int(store_all), -1))
    for c0 in range(0, n_head, 256):
        w = head[:, c0:c0 + 256]
        if store_all:
            o_n, sig = w.shape[1], -1
        elif c0 == 0:
            o_n, sig = H512_OUT, H512_SIGMA_COL if mode in "bd" else -1
        else:
            o_n, sig = 0, -1
        entries.append(("cols", h, w, zeros(w.shape[1]), c0, o_n, sig))
    return _carry(entries, rowsum=False,
                  o_pitch=n_head + (mode in "bd") if store_all else H512_OUT)


def heads_fused_operands(m1: torch.Tensor, b1: torch.Tensor, wrh2: torch.Tensor,
                         m2: torch.Tensor, b2: torch.Tensor, split: bool = False,
                         store_all: bool = False) -> ProbeOperands:
    """K10's table: sigma ([W, 16], column 0 = M1[:, 2H], bias b1[2H]); the head over
    [ed | h] ([EDP + W, 2H]: Wrh2 on the rgb columns, then M1[:, :2H]; bias b1[:2H]);
    then the output, as the port's ``out`` layer (one block-diagonal [2H, 4 + C] with
    sigma's zero column 3) or split (rgb [H, 4] over h's first H columns, its column 3
    sigma's; ins [H, C] over the last H). The output columns go to the row sum, or with
    ``store_all`` to [P, 4 + C]."""
    H, C = (m1.shape[1] - 1) // 2, m2.shape[1] - 3
    W, E = m1.shape[0], wrh2.shape[0]
    edp = _round_up(E, 16)
    dev = m1.device
    b1, b2 = b1.float().reshape(-1), b2.float().reshape(-1)
    head = torch.zeros((edp + W, 2 * H), device=dev)
    head[:E, :H] = wrh2.float()
    head[edp:] = m1[:, :2 * H].float()
    rgb = torch.cat([m2[:H, :3].float(), torch.zeros((H, 1), device=dev)], dim=1)
    rgb_b = torch.cat([b2[:3], torch.zeros(1, device=dev)])
    entries = [("sigma", (("h", 0, W),), m1[:, 2 * H:], b1[2 * H:], 0, 0, -1),
               ("relu", (("ed", 0, edp), ("h", edp, W)), head, b1[:2 * H], 0, 0, -1)]
    if split:
        entries += [("cols", (("h_lo", 0, H),), rgb, rgb_b, 0, 4, 3),
                    ("cols", (("h_hi", 0, H),), m2[H:, 3:], b2[3:], 4, C, -1)]
    else:
        out = torch.zeros((2 * H, 4 + C), device=dev)
        out[:, :3], out[:, 4:] = m2[:, :3].float(), m2[:, 3:].float()
        entries.append(("cols", (("h", 0, 2 * H),), out,
                        torch.cat([b2[:3], torch.zeros(1, device=dev), b2[3:]]), 0, 4 + C, 3))
    return _carry(entries, rowsum=not store_all, o_pitch=4 + C if store_all else 1, edp=edp)


def _probe_plan(ops: ProbeOperands) -> dict:
    """Host table of the head-probe walk of csrc/fused_mlp_fwd.cuh
    (``launch_head_probe``). ``maps`` rows (off, cols, rows, pitch): a segment of a
    transposed block, [rows = N][cols] at ``wt`` + off. ``layers`` rows (segs, N, b_off,
    epilogue, o_col, o_n, sig_col). ``chunks`` rows (map, k0): the weight boxes of one
    tile in order, one for the ed segment, four for h (its 256 register columns in
    64-column boxes), two for each half of h. ``table`` is all of it after the header
    (n_layers, n_maps, n_chunks, out kind, out pitch, EDP, 0, 0)."""
    maps, layers, chunks = [], [], []
    for L in ops.layers:
        segs = 0
        for src, k0, rows in L.segs:
            maps.append((L.w_off + k0, rows, L.N, L.K))
            segs |= _PSEG[src]
            n_boxes = {"ed": 1, "h": 4, "h_lo": 2, "h_hi": 2}[src]
            chunks += [(len(maps) - 1, _FWD_BOX_K * i) for i in range(n_boxes)]
        if L.epi == "cols" and L.o_n > L.N:
            # the epilogue reads the sums of columns [0, o_n), the layer's alone
            raise ValueError(f"a layer of {L.N} columns writes no {L.o_n}")
        layers.append((segs, L.N, L.b_off, _PEPI[L.epi], L.o_col, L.o_n, L.sig_col))
    header = [len(layers), len(maps), len(chunks), _OUT_ROWSUM if ops.rowsum else _OUT_COLS,
              ops.o_pitch, ops.edp, 0, 0]
    table = header + [v for part in (maps, layers, chunks) for r in part for v in r]
    return dict(table=table, header=header, maps=maps, layers=layers, chunks=chunks)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _launch_probe(name: str, ops: ProbeOperands, x: torch.Tensor,
                  edT: Optional[torch.Tensor], schedule: Optional[int] = None) -> torch.Tensor:
    """One launch of K9 (``head512``) or K10 (``heads_fused``) over checked inputs: x or
    h [P, 256] bf16, edT [E, P] bf16 or None. K10's consumers run under ``schedule``
    (default ``HEADS_FUSED_SCHEDULE``); K9 takes none. Returns [P, o_pitch] fp32."""
    if name == "heads_fused":
        schedule = HEADS_FUSED_SCHEDULE if schedule is None else schedule
    if schedule not in ((LOCKSTEP, PIPELINED) if name == "heads_fused" else (None,)):
        raise ValueError(f"{name} takes no schedule {schedule}")
    P = x.shape[0]
    out = torch.empty((P, ops.o_pitch), dtype=torch.float32, device=x.device)
    if P == 0:
        return out
    table = _probe_plan(ops)["table"]
    c_table = (ctypes.c_longlong * len(table))(*table)
    fn = getattr(runtime.load(name), f"dmnerf_{name}")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * (schedule is not None)
    fn.restype = ctypes.c_int
    dev = x.device
    err = fn(x.data_ptr(), None if edT is None else edT.data_ptr(),
             0 if edT is None else edT.shape[0], ops.wt.data_ptr(), ops.b.data_ptr(),
             out.data_ptr(), P, ctypes.addressof(c_table),
             torch.cuda.get_device_properties(dev).multi_processor_count,
             torch.cuda.current_stream(dev).cuda_stream, *(() if schedule is None else (schedule,)))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err} (a cudaError, or 10000 + the "
                           f"CUresult of the tensor-map encoder)")
    runtime.count_launch(name)
    return out


def _check_same_device(name: str, x: torch.Tensor, weights) -> None:
    if any(w.device != x.device for w in weights):
        raise ValueError(f"{name}: every weight must lie on {x.device}, got "
                         f"{sorted({str(w.device) for w in weights})}")


def _check_rows(name: str, x: torch.Tensor, what: str) -> None:
    if x.shape[1] != WIDTH or x.shape[0] > (1 << 31) - 128:
        raise ValueError(f"{name} holds {what} [P, {WIDTH}] with P < 2^31 - 128, got "
                         f"{tuple(x.shape)}")


def head512(mode: str, x: torch.Tensor, ws: Sequence[torch.Tensor],
            wd: Optional[torch.Tensor] = None, store_all: bool = False) -> torch.Tensor:
    """K9: [P, 32] fp32 (``store_all``: every head column, sigma last in b and d) of x
    [P, 256]. CUDA tensors (x and the weights bf16) go through the Hopper kernel, CPU
    tensors through ``head512_ref`` in fp32; there is no fallback from one to the
    other."""
    _check_head512(mode, x, ws, wd)
    if x.device.type == "cpu":
        return head512_ref(mode, x, ws, wd, torch.float32, store_all)
    _check_device_inputs("head512", (("x", x, torch.bfloat16),))
    _check_same_device("head512", x, tuple(ws) + (() if wd is None else (wd,)))
    _check_rows("head512", x, "x")
    return _launch_probe("head512", head512_operands(mode, ws, wd, store_all), x, None)


def heads_fused(h: torch.Tensor, edT: torch.Tensor, m1: torch.Tensor, b1: torch.Tensor,
                wrh2: torch.Tensor, m2: torch.Tensor, b2: torch.Tensor, split: bool = False,
                store_all: bool = False) -> torch.Tensor:
    """K10: the row sum [P, 1] fp32 (``store_all``: the columns [P, 4 + C]) of h [P, 256]
    and edT [E, P] (both bf16 on the card) with the operands of ``heads_operands`` (any
    float type; the kernel rounds the weights to bf16). CUDA tensors go through the
    Hopper kernel, CPU tensors through ``heads_fused_ref`` in fp32; no fallback."""
    H, C = _check_heads(h, edT, m1, b1, wrh2, m2, b2)
    if h.device.type == "cpu":
        rs, cols = heads_fused_ref(h, edT, m1, b1, wrh2, m2, b2, split, torch.float32)
        return cols if store_all else rs
    _check_device_inputs("heads_fused", (("h", h, torch.bfloat16), ("edT", edT, torch.bfloat16)))
    _check_same_device("heads_fused", h, (m1, b1, wrh2, m2, b2))
    _check_rows("heads_fused", h, "h")
    if 2 * H != WIDTH or edT.shape[0] > 64 or 4 + C > WIDTH:
        raise ValueError(f"heads_fused holds 2H = {WIDTH}, E <= 64 and 4 + C <= {WIDTH}, got "
                         f"H {H}, E {edT.shape[0]}, C {C}")
    return _launch_probe("heads_fused",
                         heads_fused_operands(m1, b1, wrh2, m2, b2, split, store_all), h, edT)

