"""The fused PE + DM-NeRF MLP point query and its parameter backward: three sets of
hand-written Hopper kernels, their plain PyTorch versions, the wrappers that pick
between them, the autograd function that joins them, and the host-side packing they
consume. The set follows the JAX package's ``pe_mode`` (``resolve_pe_mode``):

  'kernel_t'  K1 ``csrc/fused_mlp_fwd.cu``, K2 ``csrc/fused_mlp_bwd.cu``: the viewdir
              embedding is built per ray on the host and the kernels read row p / S
              (``_fwd_kernel_pet`` / ``_bwd_kernel_pet``, ``dmnerf_tpu/kernels/
              fused_mlp.py:507,520``); plain versions ``fused_query_ref`` /
              ``fused_query_bwd_ref``.
  'kernel'    K3 ``csrc/fused_mlp_fwd_kpe.cu``, K4 ``csrc/fused_mlp_bwd_kpe.cu``: each
              point carries its own direction and the kernels embed it as they embed
              the point (``_fwd_kernel`` / ``_bwd_kernel`` with ``_embed_pair``,
              :462,481,354); plain versions ``fused_query_kpe_ref`` /
              ``fused_query_kpe_bwd_ref``.
  'outside'   K7 ``csrc/fused_pe.cu`` embeds the points into a bf16 array e [P, EP]
              (``make_pe_pallas``, :689); the per-ray viewdir embedding is repeated to
              one bf16 row per point, ed [P, EDP]; K5 ``csrc/fused_mlp_fwd_pe.cu`` and
              K6 ``csrc/fused_mlp_bwd_pe.cu`` are the matrix-product chain and its
              backward over those two arrays (``_fwd_kernel_pe`` / ``_bwd_kernel_pe``,
              :471,494); plain versions ``pe_points_ref``, ``fused_query_pe_ref`` /
              ``fused_query_pe_bwd_ref``.

Every set computes the point embedding ``[x | sin(2^f x) | cos(2^f x)]`` in fp32, the
ReLU trunk with the embedding re-injected at each skip layer, and the fused head

    pre1 = h @ M1 + b1,   M1 = [Wrf·Wrh1 | Wif·Wih | Wd]
    rh   = relu(pre1[:, :Hr] + ed @ Wrh2),   ih = relu(pre1[:, Hr:Hr+Hi])
    raw  = [rh @ Wro + bro | pre1[:, -1] | ih @ Wio + bio]

with bf16 matrix products accumulated in fp32, fp32 biases, and activations
rounded to bf16 after each ReLU.

Packed layout (``pack_params``). Every matrix product is one layer of a table; a
layer reads a contiguous run of columns of one activation row
``[ed (EDP) | h (W) | e (EP)]`` and its weight is a zero-padded ``[K, N]`` block of
one flat buffer:

  trunk  emb0   e       @ W0[perm]                      K = EP
         plain  h       @ Wi                            K = W
         split  [h | e] @ [Wh ; We[perm]]               K = W + EP
  sigma         h       @ [Wd | 0]                      N = 16, column 0 is sigma
  head          [ed | h] @ [[Wrh2[perm] | 0] ; [Wrf·Wrh1 | Wif·Wih]]   N = pad16(Hr+Hi)
  out           [rh | ih] @ [[Wro | 0 | 0] ; [0 | 0 | Wio]]            N = pad16(4+C)

The viewdir contraction rides in the head layer's K, and the two output linears in
one block-diagonal product whose column 3 the sigma layer fills; the zero blocks add
exact zeros. Sigma has a layer of its own so that the sigma stub's sigma column is
the same product as the full model's. The forward kernels read every block
transposed, [N, K] at the same offset (``Packed.wt_bf16``: K-major, the wgmma operand
for any N), through the TMA maps of ``_fwd_plan``; the backward kernels read the blocks
as stored (``Packed.w_bf16``). Embedding widths pad to multiples of 16
(63 -> 64, 27 -> 32), head widths are runtime values (Hr = Hi = 8 and C = 1 for the
sigma stub).

Gradients. ``fused_query`` goes through a ``torch.autograd.Function`` whose
differentiable inputs are ``Packed.w`` and ``Packed.b``; autograd over
``pack_params`` (permutes, concatenations, block copies and the ``M1`` products)
carries them back to the parameter dict, which is the product rule the JAX package writes out in
``_unpack_grads``. Its backward is the JAX package's ``_backward_core``
(``dmnerf_tpu/kernels/fused_mlp.py:536``): the head's ins columns feed ``dW`` but
send nothing into the trunk, nothing goes into ``ed``, ``pts`` or ``viewdirs``, and
bias gradients are fp32 sums of the fp32 cotangents. When the query is differentiated
(``fused_query`` under grad mode with ``Packed.w`` / ``Packed.b`` requiring a
gradient), the forward kernel on the card is the training forward: it also writes a
stash of the activations in ``_bwd_plan``'s layout, which lives until the backward
reads it, so the backward recomputes nothing. The TPU kernels rematerialise instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dmnerf_tpu_torch.kernels import runtime

Params = dict

# tiling of csrc/fused_mlp_fwd.cuh
_EMB_MAX = 64          # widest embedding tile (EP, EDP) the forward holds
_N_MAX = 256           # widest layer output (and hidden width) the kernels hold
_MAX_LAYERS = 20
_EPI = {"sigma": 1, "out": 2}   # every other layer: ReLU into h
# a forward layer's A segments (csrc/fused_mlp_fwd.cuh Seg), in the order of its chunks
_SEG = {"ed": 1, "e_first": 2, "h": 4, "e_last": 8}
_FWD_BOX_K = 64        # K columns of a forward weight box
# csrc/fused_mlp_fwd.cuh Sched, the forward template's schedules of the consumers'
# products: lockstep (every launcher's unless its entry takes a schedule) and pipelined
LOCKSTEP, PIPELINED = 0, 1
SCHEDULE_NAMES = {LOCKSTEP: "lockstep", PIPELINED: "pipelined"}


def resolve_pe_mode(pe_mode) -> str:
    """The kernels of a config's ``pallas_pe_mode``: None and 'kernel_t' give K1/K2,
    'kernel' gives K3/K4, 'outside' gives K7 then K5/K6. Anything else is refused."""
    if pe_mode in (None, "kernel_t"):
        return "kernel_t"
    if pe_mode in ("kernel", "outside"):
        return pe_mode
    raise ValueError(f"unknown pallas_pe_mode {pe_mode!r}")


# ---------------------------------------------------------------------------
# Host-side packing (dmnerf_tpu/kernels/fused_mlp.py:98-180)
# ---------------------------------------------------------------------------

_CONSTANTS: dict = {}    # (what, device) -> a constant tensor of the packing, made once


def _device_constant(what, device, make) -> torch.Tensor:
    """``make()`` (a host tensor) on ``device``, copied there once and kept: the packing
    and the embedding read their index tables without a host-to-device copy a call, so a
    train step can be captured in a CUDA graph."""
    key = (what, str(torch.device(device)))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = make().to(device)
    return _CONSTANTS[key]


def _freq_matrix(multires: int, d: int = 3) -> np.ndarray:
    """F [d, d*multires] with F[c, f*d + c] = 2**f:  (x @ F)[:, f*d+c] = x_c * 2^f."""
    F = np.zeros((d, d * multires), np.float32)
    for f in range(multires):
        for c in range(d):
            F[c, f * d + c] = 2.0 ** f
    return F


def _emb_perm(multires: int, d: int = 3) -> np.ndarray:
    """Permutation from the reference embedding channel order
    [x(d), sin_f0(d), cos_f0(d), sin_f1(d), ...] to the kernel order
    [x(d), sin lanes (freq-major), cos lanes (freq-major)]."""
    sin_rows = [d + f * 2 * d + c for f in range(multires) for c in range(d)]
    cos_rows = [d + f * 2 * d + d + c for f in range(multires) for c in range(d)]
    return np.asarray(list(range(d)) + sin_rows + cos_rows, np.int64)


def _layer_kinds(D: int, skips: Tuple[int, ...]) -> List[str]:
    """'emb0' / 'plain' / 'split' per trunk layer; layer i is split when the
    embedding was concatenated after layer i-1. Skips >= D never trigger; a skip at
    D-1 would feed the heads a W+emb-wide feature and is rejected."""
    if (D - 1) in skips:
        raise ValueError(f"skip at the last trunk layer (D-1={D-1}) breaks the heads")
    return ["emb0"] + ["split" if (i - 1) in skips else "plain" for i in range(1, D)]


def _emb_dim(multires: int, d: int = 3) -> int:
    return d * (1 + 2 * multires)


def _pack(params: Params, multires: int, multires_views: int, D: int,
          skips: Tuple[int, ...]) -> List[torch.Tensor]:
    """The JAX package's ``_pack``: per trunk layer [W, b] with embedding rows in
    kernel order, then the fused head [M1, b1, Wrh2, 0, Wro, bro, Wio, bio].
    Biases are [1, n]. The rgb/ins feature linears have no activation, so they fold
    into the hidden linears by associativity, in fp32."""
    dev = params["trunk_0_w"].device
    permp = _device_constant(("perm", multires), dev, lambda: torch.as_tensor(_emb_perm(multires)))
    permd = _device_constant(("perm", multires_views), dev,
                             lambda: torch.as_tensor(_emb_perm(multires_views)))
    emb = _emb_dim(multires)
    out: List[torch.Tensor] = []
    for i, kind in enumerate(_layer_kinds(D, skips)):
        w, b = params[f"trunk_{i}_w"], params[f"trunk_{i}_b"][None, :]
        if kind == "emb0":
            out += [w[permp], b]
        elif kind == "split":
            hs = w.shape[0] - emb
            out += [torch.cat([w[:hs], w[hs:][permp]], dim=0), b]
        else:
            out += [w, b]
    wrh = params["rgb_hid_w"]
    hsd = wrh.shape[0] - _emb_dim(multires_views)
    wrh1, wrh2 = wrh[:hsd], wrh[hsd:][permd]
    wih = params["ins_hid_w"]
    Hr = wrh1.shape[1]
    m1 = torch.cat([params["rgb_feat_w"] @ wrh1, params["ins_feat_w"] @ wih,
                    params["density_w"]], dim=1)
    b1 = torch.cat([params["rgb_feat_b"] @ wrh1 + params["rgb_hid_b"],
                    params["ins_feat_b"] @ wih + params["ins_hid_b"],
                    params["density_b"]])[None, :]
    out += [m1, b1, wrh2, torch.zeros((1, Hr), dtype=m1.dtype, device=m1.device)]
    for key in ("rgb_out", "ins_out"):
        out += [params[f"{key}_w"], params[f"{key}_b"][None, :]]
    return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str    # emb0 | plain | split | sigma | head | out
    a_col: int   # first activation column it reads
    K: int
    N: int
    w_off: int   # offset of its [K, N] block in Packed.w
    b_off: int   # offset of its [N] bias in Packed.b


@dataclasses.dataclass(frozen=True)
class Packed:
    """One model's parameters in the kernel's layout (see the module docstring)."""
    w: torch.Tensor          # flat fp32 weights
    w_bf16: torch.Tensor     # the same, in bf16, as the backward kernels read them
    wt_bf16: torch.Tensor    # each [K, N] block transposed to [N, K] at the same offset,
                             # bf16: the forward kernels' K-major weight operand
    b: torch.Tensor          # flat fp32 biases
    layers: Tuple[Layer, ...]
    multires: int
    multires_views: int
    width: int               # W
    hr: int                  # rgb hidden width: the head columns that reach the trunk
    ep: int                  # padded point-embedding width
    edp: int                 # padded viewdir-embedding width
    c4: int                  # output channels, 4 + C

    def bias(self, layer: Layer) -> torch.Tensor:
        return self.b[layer.b_off:layer.b_off + layer.N]


def pack_params(params: Params, multires: int, multires_views: int, D: int,
                skips: Sequence[int]) -> Packed:
    """``_pack`` padded and laid out as the layer table of the module docstring.
    Pure parameter algebra in fp32; call once per render, not per chunk."""
    skips = tuple(skips)
    flat = _pack(params, multires, multires_views, D, skips)
    ref = flat[0]
    W = params["density_w"].shape[0]
    Ep, Ed = _emb_dim(multires), _emb_dim(multires_views)
    ep, edp = _round_up(Ep, 16), _round_up(Ed, 16)
    Hr, Hi = params["rgb_hid_w"].shape[1], params["ins_hid_w"].shape[1]
    C = params["ins_out_w"].shape[1]
    c4 = 4 + C
    nh, no = _round_up(Hr + Hi, 16), _round_up(c4, 16)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=ref.device)

    def block(K, N, parts):
        """[K, N] zeros with each (row, col, tensor) part written in."""
        z = zeros(K, N)
        for r, c, t in parts:
            z[r:r + t.shape[0], c:c + t.shape[1]] = t
        return z

    def vec(N, parts):
        z = zeros(N)
        for c, t in parts:
            z[c:c + t.shape[-1]] = t.reshape(-1)
        return z

    entries = []   # (kind, a_col, weight [K, N], bias [N])
    for i, kind in enumerate(_layer_kinds(D, skips)):
        w, b = flat[2 * i], flat[2 * i + 1].reshape(-1)
        if kind == "emb0":
            entries.append((kind, edp + W, block(ep, W, [(0, 0, w)]), b))
        elif kind == "split":
            hs = w.shape[0] - Ep
            entries.append((kind, edp, block(hs + ep, W, [(0, 0, w[:hs]), (hs, 0, w[hs:])]), b))
        else:
            entries.append((kind, edp, w, b))
    m1, b1, wrh2 = flat[2 * D], flat[2 * D + 1].reshape(-1), flat[2 * D + 2]
    wro, bro = flat[2 * D + 4], flat[2 * D + 5].reshape(-1)
    wio, bio = flat[2 * D + 6], flat[2 * D + 7].reshape(-1)
    entries.append(("sigma", edp, block(W, 16, [(0, 0, m1[:, Hr + Hi:])]),
                    vec(16, [(0, b1[Hr + Hi:])])))
    entries.append(("head", 0,
                    block(edp + W, nh, [(0, 0, wrh2), (edp, 0, m1[:, :Hr + Hi])]),
                    vec(nh, [(0, b1[:Hr + Hi])])))
    entries.append(("out", edp, block(nh, no, [(0, 0, wro), (Hr, 4, wio)]),
                    vec(no, [(0, bro), (4, bio)])))

    layers, ws, wts, bs = [], [], [], []
    w_off = b_off = 0
    for kind, a_col, w, b in entries:
        K, N = w.shape
        layers.append(Layer(kind, a_col, K, N, w_off, b_off))
        pad_w = _round_up(K * N, 64) - K * N    # keep every block 128-byte aligned
        ws += [w.reshape(-1).float(), zeros(pad_w)]
        wts += [w.detach().t().reshape(-1).float(), zeros(pad_w)]
        bs.append(b.float())
        w_off += K * N + pad_w
        b_off += N
    w = torch.cat(ws)
    return Packed(w=w, w_bf16=w.detach().to(torch.bfloat16),
                  wt_bf16=torch.cat(wts).to(torch.bfloat16), b=torch.cat(bs),
                  layers=tuple(layers), multires=multires, multires_views=multires_views,
                  width=W, hr=Hr, ep=ep, edp=edp, c4=c4)


# ---------------------------------------------------------------------------
# Embeddings in kernel lane order
# ---------------------------------------------------------------------------

def _embedding(x: torch.Tensor, multires: int, width: int) -> torch.Tensor:
    """[x | sin(x @ F) | cos(x @ F) | 0 pad] in fp32, F = _freq_matrix: lane f*3+c
    holds x_c * 2^f. The product is taken lane by lane, not as a matmul, so it is
    exact whatever the matmul precision: a rounded phase at 2^9 |x| is an O(1) error."""
    d = x.shape[-1]
    F = _freq_matrix(multires, d)
    lanes = _device_constant(("lanes", multires, d), x.device,
                             lambda: torch.from_numpy(F.argmax(axis=0)))
    scale = _device_constant(("scale", multires, d), x.device, lambda: torch.from_numpy(F.max(axis=0)))
    xs = x[:, lanes] * scale
    e = torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)
    return torch.nn.functional.pad(e, (0, width - e.shape[-1]))


def view_embedding(packed: Packed, viewdirs: torch.Tensor) -> torch.Tensor:
    """The per-ray viewdir embedding [N, EDP] the kernel reads, fp32."""
    return _embedding(viewdirs, packed.multires_views, packed.edp)


def point_view_embedding(packed: Packed, viewdirs: torch.Tensor, S: int,
                         act_dtype=torch.float32) -> torch.Tensor:
    """The per-ray viewdir embedding in ``act_dtype``, one row per point [N * S, EDP]:
    the ed that the 'outside' kernels read (the JAX query's broadcast, :913-914)."""
    return view_embedding(packed, viewdirs.float()).to(act_dtype).repeat_interleave(S, dim=0)


def pe_points_ref(packed: Packed, x: torch.Tensor, act_dtype=torch.float32) -> torch.Tensor:
    """K7's function: the point embedding [P, EP] of x [P, 3], in kernel lane order with
    a zero pad column, computed in fp32 and rounded to ``act_dtype`` (K7 gives bf16)."""
    return _embedding(x.float(), packed.multires, packed.ep).to(act_dtype)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _rounder(act_dtype):
    """Identity for fp32; a round trip through ``act_dtype`` otherwise."""
    if act_dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(act_dtype).float()


def _weights(packed: Packed, act_dtype) -> torch.Tensor:
    """The packed weights as the plain versions read them: detached, because their
    gradient is ``fused_query_bwd``'s to give (autograd through the fused head
    product would send the instance head's cotangent into the trunk)."""
    return packed.w.detach() if act_dtype == torch.float32 else packed.w_bf16.float()


def _block(w_all: torch.Tensor, layer: Layer) -> torch.Tensor:
    return w_all[layer.w_off:layer.w_off + layer.K * layer.N].view(layer.K, layer.N)


def _embeddings(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor, rnd):
    """Point embedding [P, EP] and per-point viewdir embedding [P, EDP] of a K1/K2
    query (pts [N, S, 3], viewdirs [N, 3]): the viewdir embedding per ray, repeated."""
    N, S, _ = pts.shape
    e = rnd(_embedding(pts.reshape(N * S, 3).float(), packed.multires, packed.ep))
    ed = rnd(view_embedding(packed, viewdirs.float())).repeat_interleave(S, dim=0)
    return e, ed


def _embeddings_kpe(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor, rnd):
    """The same of a K3/K4 query (pts, dirs [P, 3]): each point's own direction
    embedded, as the JAX package's ``_embed_pair``."""
    e = rnd(_embedding(pts.float(), packed.multires, packed.ep))
    ed = rnd(_embedding(dirs.float(), packed.multires_views, packed.edp))
    return e, ed


def _walk_fwd(packed: Packed, e: torch.Tensor, ed: torch.Tensor, act_dtype) -> torch.Tensor:
    """The layer table over the embeddings e [P, EP], ed [P, EDP] -> raw [P, 4+C]."""
    rnd = _rounder(act_dtype)
    w_all = _weights(packed, act_dtype)
    h = sigma = None
    for layer in packed.layers:
        w = _block(w_all, layer)
        b = packed.bias(layer)
        if layer.kind == "sigma":
            sigma = h @ w[:, :1] + b[:1]
            continue
        a = {"emb0": e, "plain": h, "out": h}.get(layer.kind)
        if layer.kind == "split":
            a = torch.cat([h, e], dim=-1)
        elif layer.kind == "head":
            a = torch.cat([ed, h], dim=-1)
        if layer.kind == "out":
            out = a @ w + b
            out[:, 3:4] = sigma
            return out[:, :packed.c4]
        h = rnd(torch.relu(a @ w + b))
    raise ValueError("packed layer table has no output layer")


def fused_query_ref(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                    act_dtype=torch.float32) -> torch.Tensor:
    """K1's function in torch ops over the same packed layout.

    pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4+C] fp32. With
    ``act_dtype=float32`` this is the CPU path and the fp32 yardstick. With
    ``bfloat16`` it rounds embeddings, weights and post-ReLU activations to bf16
    where the kernel does and keeps fp32 products and sums, so it differs from the
    kernel only in the order of the fp32 sums (run it with TF32 off)."""
    N, S, _ = pts.shape
    e, ed = _embeddings(packed, pts, viewdirs, _rounder(act_dtype))
    return _walk_fwd(packed, e, ed, act_dtype).reshape(N, S, packed.c4)


def fused_query_kpe_ref(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                        act_dtype=torch.float32) -> torch.Tensor:
    """K3's function: pts [P, 3], dirs [P, 3] (one direction per point) -> raw
    [P, 4+C] fp32, the layer walk of ``fused_query_ref`` over ``_embed_pair``'s
    embeddings, with the same roundings per ``act_dtype``."""
    e, ed = _embeddings_kpe(packed, pts, dirs, _rounder(act_dtype))
    return _walk_fwd(packed, e, ed, act_dtype)


def fused_query_pe_ref(packed: Packed, e: torch.Tensor, ed: torch.Tensor,
                       act_dtype=torch.float32) -> torch.Tensor:
    """K5's function: the layer walk of ``fused_query_ref`` over given embeddings e
    [P, EP] and ed [P, EDP] (any float type, rounded to ``act_dtype``) -> raw
    [P, 4+C] fp32."""
    rnd = _rounder(act_dtype)
    return _walk_fwd(packed, rnd(e.float()), rnd(ed.float()), act_dtype)


def _split_layers(packed: Packed):
    """(trunk layers, sigma, head, out) of a packed table."""
    *trunk, sig, head, out = packed.layers
    if (sig.kind, head.kind, out.kind) != ("sigma", "head", "out"):
        raise ValueError("packed layer table does not end in sigma, head, out")
    return trunk, sig, head, out


def _walk_bwd(packed: Packed, e: torch.Tensor, ed: torch.Tensor, g: torch.Tensor, act_dtype):
    """Parameter cotangents (dw, db) over the embeddings e [P, EP], ed [P, EDP] for the
    output cotangent g [P, 4+C]: the JAX package's ``_backward_core``."""
    rnd = _rounder(act_dtype)
    w_all = _weights(packed, act_dtype)
    trunk, sig, head, out = _split_layers(packed)
    W, hr = packed.width, packed.hr
    P = e.shape[0]

    ins, hs = [], []   # each trunk layer's input and post-ReLU output
    h = None
    for layer in trunk:
        a = {"emb0": e, "plain": h}.get(layer.kind)
        if layer.kind == "split":
            a = torch.cat([h, e], dim=-1)
        h = rnd(torch.relu(a @ _block(w_all, layer) + packed.bias(layer)))
        ins.append(a)
        hs.append(h)
    a_head = torch.cat([ed, h], dim=-1)
    hh = rnd(torch.relu(a_head @ _block(w_all, head) + packed.bias(head)))

    dw = torch.zeros_like(w_all)
    db = torch.zeros_like(packed.b.detach())

    def put(layer, a, d, d_c):
        dw[layer.w_off:layer.w_off + layer.K * layer.N] = (a.t() @ d_c).reshape(-1)
        db[layer.b_off:layer.b_off + layer.N] = d.sum(0)

    g = g.reshape(P, packed.c4).float()
    d_out = torch.zeros((P, out.N), dtype=torch.float32, device=g.device)
    d_out[:, :packed.c4] = g
    d_out[:, 3] = 0.0                      # sigma's column belongs to the sigma layer
    d_out_c = rnd(d_out)
    put(out, hh, d_out, d_out_c)
    d_hh = (d_out_c @ _block(w_all, out).t()) * (hh > 0)
    d_hh_c = rnd(d_hh)
    put(head, a_head, d_hh, d_hh_c)
    d_sig = torch.zeros((P, sig.N), dtype=torch.float32, device=g.device)
    d_sig[:, 0] = g[:, 3]
    d_sig_c = rnd(d_sig)
    put(sig, h, d_sig, d_sig_c)

    # the wall: the ins columns [hr, hr+Hi) of the head reach dW only
    d_h = d_hh_c[:, :hr] @ _block(w_all, head)[packed.edp:, :hr].t() \
        + d_sig_c @ _block(w_all, sig).t()
    for i in range(len(trunk) - 1, -1, -1):
        d = d_h * (hs[i] > 0)
        d_c = rnd(d)
        put(trunk[i], ins[i], d, d_c)
        if trunk[i].kind != "emb0":
            d_h = d_c @ _block(w_all, trunk[i])[:W].t()
    return dw, db


def fused_query_bwd_ref(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                        g: torch.Tensor, act_dtype=torch.float32):
    """K2's function in torch ops: the parameter cotangents ``(dw, db)`` of
    ``fused_query`` in ``Packed.w`` / ``Packed.b`` layout, fp32, for the output
    cotangent g [N, S, 4+C]. It walks the layer table as the JAX package's
    ``_backward_core`` walks its layers: out, head, sigma, then the trunk in reverse
    through the ReLU masks. Only the head's rgb columns and sigma send a cotangent
    into the trunk (the instance head's detach); nothing goes into ``ed``.

    With ``bfloat16`` it rounds where the kernel does: embeddings, weights and
    activations, and each cotangent once before it enters a product. Bias gradients
    are sums of the unrounded fp32 cotangents either way."""
    e, ed = _embeddings(packed, pts, viewdirs, _rounder(act_dtype))
    return _walk_bwd(packed, e, ed, g, act_dtype)


def fused_query_kpe_bwd_ref(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                            g: torch.Tensor, act_dtype=torch.float32):
    """K4's function: ``fused_query_bwd_ref``'s walk for pts, dirs [P, 3] and the
    output cotangent g [P, 4+C], over ``_embed_pair``'s embeddings. Nothing goes into
    ``pts`` or ``dirs`` (the JAX package returns zeros for them)."""
    e, ed = _embeddings_kpe(packed, pts, dirs, _rounder(act_dtype))
    return _walk_bwd(packed, e, ed, g, act_dtype)


def fused_query_pe_bwd_ref(packed: Packed, e: torch.Tensor, ed: torch.Tensor,
                           g: torch.Tensor, act_dtype=torch.float32):
    """K6's function: ``fused_query_bwd_ref``'s walk over given embeddings e [P, EP],
    ed [P, EDP] for the output cotangent g [P, 4+C]. Nothing goes into e or ed (the
    JAX package returns zeros for them)."""
    rnd = _rounder(act_dtype)
    return _walk_bwd(packed, rnd(e.float()), rnd(ed.float()), g, act_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_device_inputs(name: str, inputs) -> None:
    """A launch's card and its tensors' device, type and contiguity: ``inputs`` is
    (what, tensor, dtype) triples, all on the first one's device."""
    dev = inputs[0][1].device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{name} is built for sm_90a; device {dev} is "
                           f"sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")
    for what, t, dt in inputs:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: want a contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _check_kernel_inputs(name: str, packed: Packed, a: torch.Tensor, b: torch.Tensor,
                         names=("pts", "viewdirs"), dtype=torch.float32) -> None:
    """Device, types and contiguity of a query launch, and the packed table's fit to
    the kernels' tiling. ``a``, ``b`` are the points and the per-ray viewdirs (K1, K2)
    or the per-point directions (K3, K4), fp32, or the embeddings e and ed (K5, K6),
    bf16; the callers check the shapes."""
    _check_device_inputs(name, ((names[0], a, dtype), (names[1], b, dtype),
                                ("packed.w_bf16", packed.w_bf16, torch.bfloat16),
                                ("packed.wt_bf16", packed.wt_bf16, torch.bfloat16),
                                ("packed.b", packed.b, torch.float32)))
    if packed.ep > _EMB_MAX or packed.edp > _EMB_MAX or packed.width > _N_MAX \
            or packed.width % 16:
        raise ValueError(f"kernel holds embeddings of at most {_EMB_MAX} columns and hidden "
                         f"widths of at most {_N_MAX} with W % 16 == 0; got EP {packed.ep}, "
                         f"EDP {packed.edp}, W {packed.width}")
    if len(packed.layers) > _MAX_LAYERS:
        raise ValueError(f"kernel takes at most {_MAX_LAYERS} layers, got {len(packed.layers)}")
    for layer in packed.layers:
        if layer.K % 16 or layer.N % 16 or layer.N > _N_MAX:
            raise ValueError(f"kernel wants K, N multiples of 16 and N <= {_N_MAX}: {layer}")


def _check_ray_shapes(pts: torch.Tensor, viewdirs: torch.Tensor) -> None:
    if pts.dim() != 3 or pts.shape[-1] != 3 or viewdirs.shape != (pts.shape[0], 3):
        raise ValueError(f"want pts [N, S, 3] and viewdirs [N, 3], got "
                         f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}")


def _check_point_shapes(pts: torch.Tensor, dirs: torch.Tensor) -> None:
    if pts.dim() != 2 or pts.shape[-1] != 3 or dirs.shape != pts.shape:
        raise ValueError(f"want pts [P, 3] and dirs [P, 3], got "
                         f"{tuple(pts.shape)} and {tuple(dirs.shape)}")


def _check_embedding_shapes(packed: Packed, e: torch.Tensor, ed: torch.Tensor) -> None:
    if e.dim() != 2 or e.shape[1] != packed.ep or ed.shape != (e.shape[0], packed.edp):
        raise ValueError(f"want e [P, {packed.ep}] and ed [P, {packed.edp}], got "
                         f"{tuple(e.shape)} and {tuple(ed.shape)}")


def _fwd_segments(packed: Packed, layer: Layer):
    """A forward layer's A segments in chunk order: (source, first K row, rows), the
    source one of 'ed', 'e_first', 'h', 'e_last' (csrc/fused_mlp_fwd.cuh Seg)."""
    if layer.kind == "emb0":
        return [("e_first", 0, layer.K)]
    if layer.kind == "split":
        return [("h", 0, layer.K - packed.ep), ("e_last", layer.K - packed.ep, packed.ep)]
    if layer.kind == "head":
        return [("ed", 0, packed.edp), ("h", packed.edp, layer.K - packed.edp)]
    return [("h", 0, layer.K)]          # plain, sigma, out


def _fwd_plan(packed: Packed) -> dict:
    """Host table of csrc/fused_mlp_fwd.cuh. Each A segment of each layer is a TMA map
    over the layer's block of ``Packed.wt_bf16`` ([N, K], row pitch K): ``maps`` rows
    (off, cols, rows, pitch), the segment's [N, rows of K] starting at element ``off``.
    ``layers`` rows (segs, N, b_off, epilogue). ``chunks`` rows (map, k0): the weight
    boxes of one tile in the order the consumers take them, one per segment from the
    embedding tiles and four for h (its 256 register columns in 64-column boxes; K
    columns past a segment arrive as zeros). ``table`` is all of it flattened after the
    header (n_layers, n_maps, n_chunks, c4, EP, EDP, multires, multires_views)."""
    maps, layers, chunks = [], [], []
    for layer in packed.layers:
        segs = 0
        for src, k0, rows in _fwd_segments(packed, layer):
            maps.append((layer.w_off + k0, rows, layer.N, layer.K))
            segs |= _SEG[src]
            n_boxes = _N_MAX // _FWD_BOX_K if src == "h" else 1
            chunks += [(len(maps) - 1, _FWD_BOX_K * i) for i in range(n_boxes)]
        if layer.kind == "out" and packed.c4 > layer.N:
            # the output epilogue reads the sums of columns [0, c4), the layer's alone
            raise ValueError(f"output layer of {layer.N} columns holds no {packed.c4}")
        layers.append((segs, layer.N, layer.b_off, _EPI.get(layer.kind, 0)))
    header = [len(layers), len(maps), len(chunks), packed.c4, packed.ep, packed.edp,
              packed.multires, packed.multires_views]
    table = header + [v for part in (maps, layers, chunks) for r in part for v in r]
    return dict(table=table, maps=maps, layers=layers, chunks=chunks)


def _launch_fwd(name: str, packed: Packed, pts: torch.Tensor, ed_src: torch.Tensor,
                P: int, S: int, stash=None, stash_table=None) -> torch.Tensor:
    """One launch of K1 (``ed_src`` the per-ray viewdir embedding [P / S, EDP] bf16),
    K3 (``ed_src`` the directions [P, 3] fp32) or K5 (``pts`` the point embedding e
    [P, EP], ``ed_src`` the per-point viewdir embedding [P, EDP], both bf16); returns
    raw [P, 4+C]. With ``stash`` (a bf16 buffer) and ``stash_table`` (``_bwd_plan``'s
    ``fwd_stash``) it is the training forward, which also writes what the backward
    reads."""
    out = torch.empty((P, packed.c4), dtype=torch.float32, device=pts.device)
    if P == 0:
        return out
    table = _fwd_plan(packed)["table"]
    c_table = (ctypes.c_longlong * len(table))(*table)
    c_stash = None if stash is None else (ctypes.c_longlong * len(stash_table))(*stash_table)
    fn = getattr(runtime.load(name), f"dmnerf_{name}")
    dev = pts.device
    head = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * (name == "fused_mlp_fwd")
    fn.argtypes = head + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(pts.data_ptr(), ed_src.data_ptr(), packed.wt_bf16.data_ptr(), packed.b.data_ptr(),
             out.data_ptr(), P, *((S,) if name == "fused_mlp_fwd" else ()),
             ctypes.addressof(c_table), None if stash is None else stash.data_ptr(),
             None if c_stash is None else ctypes.addressof(c_stash),
             torch.cuda.get_device_properties(dev).multi_processor_count,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err} (a cudaError, or 10000 + the "
                           f"CUresult of the tensor-map encoder)")
    runtime.count_launch(name)
    return out


def _forward(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """K1 routing: the fp32 plain version for CPU tensors, the kernel for CUDA tensors.
    pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4+C]."""
    if pts.device.type == "cpu":
        return fused_query_ref(packed, pts, viewdirs, torch.float32)
    N, S, _ = pts.shape
    _, edr = _kernel_inputs(packed, pts, viewdirs, "kernel_t")
    return _launch_fwd("fused_mlp_fwd", packed, pts, edr, N * S, S).reshape(N, S, packed.c4)


def _forward_kpe(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """K3 routing: the fp32 plain version for CPU tensors, the kernel for CUDA tensors.
    pts [P, 3], dirs [P, 3] -> raw [P, 4+C]."""
    if pts.device.type == "cpu":
        return fused_query_kpe_ref(packed, pts, dirs, torch.float32)
    _check_kernel_inputs("fused_mlp_fwd_kpe", packed, pts, dirs)
    _check_point_shapes(pts, dirs)
    return _launch_fwd("fused_mlp_fwd_kpe", packed, pts, dirs, pts.shape[0], 1)


def _forward_pe(packed: Packed, e: torch.Tensor, ed: torch.Tensor) -> torch.Tensor:
    """K5 routing: the fp32 plain version for CPU tensors, the kernel for CUDA tensors
    (e [P, EP] and ed [P, EDP] bf16). -> raw [P, 4+C]."""
    if e.device.type == "cpu":
        return fused_query_pe_ref(packed, e, ed, torch.float32)
    _check_kernel_inputs("fused_mlp_fwd_pe", packed, e, ed, ("e", "ed"), torch.bfloat16)
    _check_embedding_shapes(packed, e, ed)
    return _launch_fwd("fused_mlp_fwd_pe", packed, e, ed, e.shape[0], 1)


def pe_points(packed: Packed, x: torch.Tensor) -> torch.Tensor:
    """The point embedding e [P, EP] of x [P, 3] fp32: K7 for a CUDA tensor (bf16), the
    fp32 plain version ``pe_points_ref`` for a CPU tensor; no fallback."""
    if x.device.type == "cpu":
        return pe_points_ref(packed, x, torch.float32)
    _check_device_inputs("fused_pe", (("x", x, torch.float32),))
    if x.dim() != 2 or x.shape[-1] != 3:
        raise ValueError(f"want x [P, 3], got {tuple(x.shape)}")
    e = torch.empty((x.shape[0], packed.ep), dtype=torch.bfloat16, device=x.device)
    if x.shape[0]:
        _pe_launcher(x, e, packed.multires)()
    return e


# tiling of csrc/fused_pe.cu: one thread a point, tiles of 128 points, two staging tiles
# a block
_PE_TILE, _PE_STAGES = 128, 2
_PE_ARGTYPES = {
    "dmnerf_fused_pe": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "dmnerf_fused_pe_blocks_per_sm": [ctypes.c_int, ctypes.c_int],
}
_PE_BLOCKS_PER_SM: dict = {}   # (device, multires, width) -> the occupancy query's answer


def _pe_lib() -> ctypes.CDLL:
    """K7's library, the ctypes signatures of its entries set once, when it is loaded."""
    lib = runtime.load("fused_pe")
    if not getattr(lib, "typed", False):
        for sym, argtypes in _PE_ARGTYPES.items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.typed = True
    return lib


def _pe_plan(P: int, width: int, n_sms: int, blocks_per_sm: int) -> dict:
    """Host plan of csrc/fused_pe.cu for P points of ``width`` bf16 columns, as the kernel
    takes it. ``grid`` blocks of ``tile`` threads, block b walking tiles b, b + grid, ...
    of ``tiles``: at most ``n_sms * blocks_per_sm`` blocks, and as few as still give each
    block ``tiles_per_block`` tiles or one less. Thread t stages row p0 + t (rows < P) at
    row t of its block's staging tile, the tiles lying ``copy_bytes`` apart in the
    block's ``staging_bytes``; then tile i is one bulk copy of ``copy_bytes``
    (``last_copy_bytes``, its ``last_rows`` rows, for the last tile) from its staging tile
    to byte ``i * copy_bytes`` of e."""
    tiles = -(-P // _PE_TILE)
    per_block = -(-tiles // (n_sms * blocks_per_sm))
    last_rows = P - (tiles - 1) * _PE_TILE
    copy_bytes = _PE_TILE * width * 2
    return dict(tile=_PE_TILE, tiles=tiles, grid=-(-tiles // per_block),
                tiles_per_block=per_block, last_rows=last_rows, copy_bytes=copy_bytes,
                last_copy_bytes=last_rows * width * 2, staging_bytes=_PE_STAGES * copy_bytes)


def _pe_launcher(x: torch.Tensor, e: torch.Tensor, multires: int):
    """A function of no arguments that launches K7 once: x [P, 3] fp32 (contiguous) into
    e [P, width] bf16 (contiguous, 16-byte aligned), on the stream that is current now,
    with the plan, the pointers and the library function bound now. Each call counts
    one launch, and raises if the launch was refused."""
    P, width = e.shape
    if P == 0 or x.shape != (P, 3) or not (x.is_contiguous() and e.is_contiguous()) \
            or e.dtype != torch.bfloat16 or e.data_ptr() % 16 or width % 8 or width > 256:
        raise ValueError(f"fused_pe wants x [P, 3] and e [P, width] bf16, contiguous, e "
                         f"16-byte aligned, width a multiple of 8 up to 256, P > 0; got x "
                         f"{tuple(x.shape)}, e {tuple(e.shape)} {e.dtype}")
    dev = x.device
    lib = _pe_lib()
    key = (dev.index, multires, width)
    if key not in _PE_BLOCKS_PER_SM:
        n = lib.dmnerf_fused_pe_blocks_per_sm(multires, width)
        if n < 1:
            raise RuntimeError(f"fused_pe occupancy query failed: cudaError {-n}")
        _PE_BLOCKS_PER_SM[key] = n
    plan = _pe_plan(P, width, torch.cuda.get_device_properties(dev).multi_processor_count,
                    _PE_BLOCKS_PER_SM[key])
    fn = lib.dmnerf_fused_pe
    args = (x.data_ptr(), e.data_ptr(), P, multires, width, plan["tile"], plan["tiles"],
            plan["copy_bytes"], plan["last_copy_bytes"], plan["staging_bytes"], plan["grid"],
            torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"fused_pe launch failed: cudaError {err}")
        runtime.count_launch("fused_pe")
    return launch


# tiling of csrc/fused_mlp_bwd.cuh: 128-point tiles of the backward-data walk (a bias
# partial each); dW tiles of 128 features over 64-point stages; every stash, cotangent
# and weight segment starts on 64 elements (128 bytes), as TMA wants
_BWD_TILE, _DW_TILE_F, _DW_POINTS, _WBOX_K = 128, 128, 64, 64
_DW_CTAS_PER_SM = 4
_SEG_ALIGN = 64
# the Rows of each pe_mode's kernel pair, and the pair's entry points
_ROWS = {"kernel_t": "ray_table", "kernel": "point_dirs", "outside": "embedded"}
_FWD_NAME = {"kernel_t": "fused_mlp_fwd", "kernel": "fused_mlp_fwd_kpe",
             "outside": "fused_mlp_fwd_pe"}
_BWD_NAME = {"kernel_t": "fused_mlp_bwd", "kernel": "fused_mlp_bwd_kpe",
             "outside": "fused_mlp_bwd_pe"}


def _bwd_plan(packed: Packed, N: int, S: int, n_sms: int, rows: str = "ray_table"):
    """Host tables of the training forward's stash and of csrc/fused_mlp_bwd.cuh.
    ``rows`` is the kernel pair's Rows: 'ray_table' (K1/K2) and 'point_dirs' (K3/K4)
    stash the point embedding and the per-point viewdir embedding as the forward built
    them; 'embedded' (K5/K6, S = 1) stashes neither, and its dW jobs read e [P, EP]
    (segment source 2) and ed [P, EDP] (source 1) from the backward's inputs.

    Returns a dict: ``stash_size``, ``e_off``, ``ed_off`` and ``layer_off`` (one stash
    offset per packed layer, -1 for sigma and out; each stash segment is [P, width]
    row-major), ``fwd_stash`` (the forward's table: e_off, ed_off, *layer_off),
    ``dpre_off`` / ``dpre_size`` (one [P, N] bf16 cotangent block per layer), the rows
    of the backward's table (``wmaps``: weight blocks (w_off, cols, rows) read as
    [rows, cols] with pitch cols; ``steps``: (N, chunk0, n_chunks, b_off, mask_off,
    dpre_off); ``wchunks``: (map, k0, a0, n16); ``dmaps``: (src, off, width) over P
    rows, src 0 stash, 1 input ed, 2 input e, 3 cotangents; ``jobs``: (amap, bmap,
    width, N, k_off, w_off); ``ranges``: (w_off, size)), the header values, and
    ``table``, all of it flattened as the kernel reads it. Every offset is in elements
    and a multiple of 64."""
    trunk, sig, head, out = _split_layers(packed)
    P, W, ep, edp, hr, D = N * S, packed.width, packed.ep, packed.edp, packed.hr, len(trunk)
    if hr % 16 or hr > 3 * _WBOX_K:
        raise ValueError(f"backward kernel wants the rgb hidden width % 16 == 0 and "
                         f"<= {3 * _WBOX_K}, got {hr}")
    if rows not in _ROWS.values() or (rows == "embedded" and S != 1):
        raise ValueError(f"unknown rows {rows!r} for S = {S}")
    li = {layer: i for i, layer in enumerate(packed.layers)}

    def allocator():
        size = [0]

        def take(n):
            o = size[0]
            size[0] += _round_up(n, _SEG_ALIGN)
            return o
        return take, size
    # stash (bf16): e [P, EP] and ed [P, EDP] (not K6), each trunk layer's output
    # [P, W], the head's [P, nh]
    take, stash_size = allocator()
    e_off = -1 if rows == "embedded" else take(P * ep)
    ed_off = -1 if rows == "embedded" else take(P * edp)
    h_off = [take(P * W) for _ in trunk]
    head_off = take(P * head.N)
    layer_off = h_off + [-1, head_off, -1]
    # cotangents d_pre (bf16), one [P, N] block per layer
    take, dpre_size = allocator()
    dpre_off = [take(P * layer.N) for layer in packed.layers]

    # backward-data walk: weight blocks as TMA maps, each row one input feature
    wmaps = [(out.w_off, out.N, head.N),                    # out [nh, no]
             (head.w_off + edp * head.N, head.N, W),        # the head's h rows [W, nh]
             (sig.w_off, sig.N, W)]                         # sigma [W, 16]
    wmaps += [(trunk[i].w_off, W, W) for i in range(D - 1, 0, -1)]   # trunk i's h rows
    steps, wchunks = [], []

    def step(n, b_off, mask_off, d_off, parts):
        c0 = len(wchunks)
        for m, K, a0 in parts:
            wchunks.extend((m, k0, a0 + k0 // 16, min(_WBOX_K, K - k0) // 16)
                           for k0 in range(0, K, _WBOX_K))
        steps.append((n, c0, len(wchunks) - c0, b_off, mask_off, d_off))
    step(head.N, head.b_off, head_off, dpre_off[li[head]], [(0, out.N, 0)])
    # the wall: only the head's rgb columns and sigma (its fragment at column hr) reach h
    step(W, trunk[D - 1].b_off, h_off[D - 1], dpre_off[D - 1], [(1, hr, 0), (2, sig.N, hr // 16)])
    for k, i in enumerate(range(D - 1, 0, -1)):
        step(W, trunk[i - 1].b_off, h_off[i - 1], dpre_off[i - 1], [(3 + k, W, 0)])

    # dW jobs: one per (layer, A segment), over TMA maps of [P, width] rows
    dmaps = []

    def dmap(src, o, width):
        if (src, o, width) not in dmaps:
            dmaps.append((src, o, width))
        return dmaps.index((src, o, width))
    e_map = dmap(2, 0, ep) if rows == "embedded" else dmap(0, e_off, ep)
    ed_map = dmap(1, 0, edp) if rows == "embedded" else dmap(0, ed_off, edp)
    h_map = [dmap(0, o, W) for o in h_off]
    segs = []
    for i, layer in enumerate(trunk):
        segs.append((layer, [(e_map, ep)] if layer.kind == "emb0" else
                     [(h_map[i - 1], W), (e_map, ep)] if layer.kind == "split" else
                     [(h_map[i - 1], W)]))
    segs += [(sig, [(h_map[D - 1], W)]), (head, [(ed_map, edp), (h_map[D - 1], W)]),
             (out, [(dmap(0, head_off, head.N), head.N)])]
    jobs, n_tiles = [], 0
    for layer, parts in segs:
        if sum(width for _, width in parts) != layer.K:
            raise ValueError(f"dW segments do not cover K of {layer}")
        bmap, k = dmap(3, dpre_off[li[layer]], layer.N), 0
        for amap, width in parts:
            jobs.append((amap, bmap, width, layer.N, k, layer.w_off))
            k += width
            n_tiles += -(-width // _DW_TILE_F)
    n_chunks = max(1, min(-(-P // _DW_POINTS), -(-_DW_CTAS_PER_SM * n_sms // n_tiles)))
    chunk = _round_up(max(1, -(-P // n_chunks)), _DW_POINTS)
    n_chunks = max(1, -(-P // chunk))
    ranges = [(layer.w_off, layer.K * layer.N) for layer in packed.layers]

    header = [P, packed.c4, out.N, hr, packed.b.numel(), packed.w.numel(), out.b_off,
              sig.b_off, dpre_off[li[out]], dpre_off[li[sig]], n_chunks, chunk, len(wmaps),
              len(steps), len(wchunks), len(dmaps), len(jobs), len(ranges)]
    table = header + [v for part in (wmaps, steps, wchunks, dmaps, jobs, ranges)
                      for r in part for v in r]
    return dict(table=table, header=header, stash_size=stash_size[0], e_off=e_off,
                ed_off=ed_off, layer_off=layer_off, fwd_stash=[e_off, ed_off, *layer_off],
                dpre_off=dpre_off, dpre_size=dpre_size[0], wmaps=wmaps, steps=steps,
                wchunks=wchunks, dmaps=dmaps, jobs=jobs, ranges=ranges, n_chunks=n_chunks,
                chunk=chunk, bias_rows=-(-P // _BWD_TILE))


def _check_cotangent(g: torch.Tensor, shape, device) -> None:
    if g.shape != shape or g.dtype != torch.float32 or g.device != device \
            or not g.is_contiguous():
        raise ValueError(f"g: want a contiguous float32 {list(shape)} tensor on {device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")


def _kernel_inputs(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor, pe_mode: str):
    """The two inputs of ``pe_mode``'s kernels for a query pts [N, S, 3], viewdirs
    [N, 3] on the card, checked: 'kernel_t' the points and the per-ray viewdir
    embedding [N, EDP] bf16, 'kernel' the points and one direction per point [P, 3],
    'outside' K7's point embedding e [P, EP] and the per-point viewdir embedding
    [P, EDP], bf16."""
    if pe_mode == "kernel_t":
        _check_kernel_inputs(_FWD_NAME[pe_mode], packed, pts, viewdirs)
        _check_ray_shapes(pts, viewdirs)
        return pts, view_embedding(packed, viewdirs).to(torch.bfloat16).contiguous()
    _check_ray_shapes(pts, viewdirs)
    N, S, _ = pts.shape
    if pe_mode == "kernel":
        a, d = pts.reshape(N * S, 3).contiguous(), _point_dirs(viewdirs, S)
        _check_kernel_inputs(_FWD_NAME[pe_mode], packed, a, d)
        return a, d
    e = pe_points(packed, pts.reshape(N * S, 3).contiguous())
    ed = point_view_embedding(packed, viewdirs, S, torch.bfloat16)
    _check_kernel_inputs(_FWD_NAME[pe_mode], packed, e, ed, ("e", "ed"), torch.bfloat16)
    return e, ed


def _stash_forward(pe_mode: str, packed: Packed, a: torch.Tensor, b: torch.Tensor, N: int, S: int):
    """The training forward of ``pe_mode`` over its kernel inputs ``a``, ``b`` (as
    ``_kernel_inputs`` gives them): one launch of K1, K3 or K5 that also writes the
    stash. Returns (raw [N * S, 4+C], plan, stash)."""
    plan = _bwd_plan(packed, N, S, torch.cuda.get_device_properties(a.device).multi_processor_count,
                     _ROWS[pe_mode])
    stash = torch.empty(plan["stash_size"], dtype=torch.bfloat16, device=a.device)
    raw = _launch_fwd(_FWD_NAME[pe_mode], packed, a, b, N * S, S, stash, plan["fwd_stash"])
    return raw, plan, stash


def _launch_bwd(pe_mode: str, packed: Packed, plan: dict, stash: torch.Tensor,
                g: torch.Tensor, e_in=None, ed_in=None):
    """One call of K2, K4 or K6 (``pe_mode``) over the stash that ``_stash_forward``
    wrote, for the output cotangent g [P, 4+C] fp32 (K6 also reads its input
    embeddings e_in, ed_in): its four device launches, and (dw, db)."""
    name = _BWD_NAME[pe_mode]
    dev = stash.device
    P = plan["header"][0]
    _check_cotangent(g, (P, packed.c4), dev)
    if P == 0:
        return torch.zeros_like(packed.w.detach()), torch.zeros_like(packed.b.detach())
    dw = torch.empty(packed.w.shape, dtype=torch.float32, device=dev)
    db = torch.empty(packed.b.shape, dtype=torch.float32, device=dev)
    dpre = torch.empty(plan["dpre_size"], dtype=torch.bfloat16, device=dev)
    dbpart = torch.empty((plan["bias_rows"], db.numel()), dtype=torch.float32, device=dev)
    dwpart = torch.empty((plan["n_chunks"], dw.numel()), dtype=torch.float32, device=dev)
    table = plan["table"]
    c_table = (ctypes.c_longlong * len(table))(*table)
    fn = getattr(runtime.load(name), f"dmnerf_{name}")
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(None if e_in is None else e_in.data_ptr(),
             None if ed_in is None else ed_in.data_ptr(), packed.w_bf16.data_ptr(),
             g.data_ptr(), stash.data_ptr(), dpre.data_ptr(), dbpart.data_ptr(),
             dwpart.data_ptr(), dw.data_ptr(), db.data_ptr(), ctypes.addressof(c_table),
             torch.cuda.get_device_properties(dev).multi_processor_count,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err} (a cudaError, or 10000 + the "
                           f"CUresult of the tensor-map encoder)")
    runtime.count_launch(name)
    return dw, db


def fused_query_bwd(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                    g: torch.Tensor):
    """Parameter cotangents ``(dw, db)`` of the K1 query for the output cotangent
    g [N, S, 4+C] fp32, in ``Packed.w`` / ``Packed.b`` layout. CUDA tensors go
    through the training forward (K1 writing the stash) and the Hopper kernel (K2),
    CPU tensors through ``fused_query_bwd_ref`` in fp32; there is no fallback from one
    to the other."""
    if pts.device.type == "cpu":
        return fused_query_bwd_ref(packed, pts, viewdirs, g, torch.float32)
    a, b = _kernel_inputs(packed, pts, viewdirs, "kernel_t")
    N, S, _ = pts.shape
    _check_cotangent(g, (N, S, packed.c4), pts.device)
    _, plan, stash = _stash_forward("kernel_t", packed, a, b, N, S)
    return _launch_bwd("kernel_t", packed, plan, stash, g.reshape(N * S, packed.c4))


def fused_query_kpe_bwd(packed: Packed, pts: torch.Tensor, dirs: torch.Tensor,
                        g: torch.Tensor):
    """Parameter cotangents ``(dw, db)`` of the K3 query (pts, dirs [P, 3]) for the
    output cotangent g [P, 4+C] fp32. CUDA tensors go through K3 writing the stash and
    the Hopper kernel (K4), CPU tensors through ``fused_query_kpe_bwd_ref`` in fp32;
    there is no fallback."""
    if pts.device.type == "cpu":
        return fused_query_kpe_bwd_ref(packed, pts, dirs, g, torch.float32)
    _check_kernel_inputs("fused_mlp_bwd_kpe", packed, pts, dirs)
    _check_point_shapes(pts, dirs)
    P = pts.shape[0]
    _check_cotangent(g, (P, packed.c4), pts.device)
    _, plan, stash = _stash_forward("kernel", packed, pts, dirs, P, 1)
    return _launch_bwd("kernel", packed, plan, stash, g)


def fused_query_pe_bwd(packed: Packed, e: torch.Tensor, ed: torch.Tensor, g: torch.Tensor):
    """Parameter cotangents ``(dw, db)`` of the K5 query over the embeddings e [P, EP]
    and ed [P, EDP] for the output cotangent g [P, 4+C] fp32. CUDA tensors (bf16
    embeddings) go through K5 writing the stash and the Hopper kernel (K6), CPU
    tensors through ``fused_query_pe_bwd_ref`` in fp32; there is no fallback."""
    if e.device.type == "cpu":
        return fused_query_pe_bwd_ref(packed, e, ed, g, torch.float32)
    _check_kernel_inputs("fused_mlp_bwd_pe", packed, e, ed, ("e", "ed"), torch.bfloat16)
    _check_embedding_shapes(packed, e, ed)
    P = e.shape[0]
    _check_cotangent(g, (P, packed.c4), e.device)
    _, plan, stash = _stash_forward("outside", packed, e, ed, P, 1)
    return _launch_bwd("outside", packed, plan, stash, g, e, ed)


def _point_dirs(viewdirs: torch.Tensor, S: int) -> torch.Tensor:
    """Per-ray viewdirs [N, 3] broadcast to one direction per point [N * S, 3], as the
    JAX package's 'kernel' query does (``dmnerf_tpu/kernels/fused_mlp.py:918``)."""
    return viewdirs[:, None, :].expand(viewdirs.shape[0], S, 3).reshape(-1, 3).contiguous()


class _FusedQuery(torch.autograd.Function):
    """raw = query(w, b): differentiable in ``Packed.w`` and ``Packed.b`` only. The
    points and viewdirs get no cotangent, as in the JAX package, whose callers stop
    their gradient (``dmnerf_tpu/kernels/fused_mlp.py:905,915``) or whose backward
    returns zeros for them (:819-820). ``pe_mode`` picks the kernels: 'kernel_t'
    K1/K2, 'kernel' K3/K4 over per-point directions, 'outside' K7 and K5/K6 over the
    embeddings, which the forward builds once and saves for the backward, as the JAX
    rule saves ``(params, e, ed)`` (:846-847).

    ``stash`` (decided by ``fused_query`` from the grad mode) makes the forward on the
    card the training forward: the forward kernel also writes the activations the
    backward reads, so the backward launches only K2 / K4 / K6 and recomputes nothing.
    Without it (render, manipulation and ScanNet views under ``no_grad``, and every
    CPU query) the forward is the render path's."""

    @staticmethod
    def forward(ctx, w, b, packed, pts, viewdirs, pe_mode, stash):
        ctx.packed, ctx.pe_mode, ctx.plan = packed, pe_mode, None
        N, S, _ = pts.shape
        if stash and pts.device.type == "cuda":
            a, d = _kernel_inputs(packed, pts, viewdirs, pe_mode)
            n_s = (N, S) if pe_mode == "kernel_t" else (N * S, 1)
            raw, ctx.plan, buf = _stash_forward(pe_mode, packed, a, d, *n_s)
            ctx.save_for_backward(buf, *((a, d) if pe_mode == "outside" else ()))
            return raw.reshape(N, S, packed.c4)
        if pe_mode == "kernel_t":
            ctx.save_for_backward(pts, viewdirs)
            return _forward(packed, pts, viewdirs)
        if pe_mode == "outside":
            e = pe_points(packed, pts.reshape(N * S, 3).contiguous())
            ed = point_view_embedding(packed, viewdirs, S, e.dtype)
            ctx.save_for_backward(e, ed)
            return _forward_pe(packed, e, ed).reshape(N, S, packed.c4)
        ctx.save_for_backward(pts, viewdirs)
        raw = _forward_kpe(packed, pts.reshape(N * S, 3), _point_dirs(viewdirs, S))
        return raw.reshape(N, S, packed.c4)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.packed
        g = g.reshape(-1, packed.c4).contiguous()
        if ctx.plan is not None:
            stash, *emb = ctx.saved_tensors
            dw, db = _launch_bwd(ctx.pe_mode, packed, ctx.plan, stash, g, *emb)
        elif ctx.pe_mode == "kernel_t":
            pts, viewdirs = ctx.saved_tensors
            dw, db = fused_query_bwd(packed, pts, viewdirs, g.reshape(pts.shape[:2] + (-1,)))
        elif ctx.pe_mode == "outside":
            e, ed = ctx.saved_tensors
            dw, db = fused_query_pe_bwd(packed, e, ed, g)
        else:
            pts, viewdirs = ctx.saved_tensors
            N, S, _ = pts.shape
            dw, db = fused_query_kpe_bwd(packed, pts.reshape(N * S, 3), _point_dirs(viewdirs, S), g)
        return dw, db, None, None, None, None, None


def fused_query(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                pe_mode=None) -> torch.Tensor:
    """Point query pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4+C] fp32.

    ``pe_mode`` (``resolve_pe_mode``) picks the kernels: None or 'kernel_t' K1
    forward / K2 backward, 'kernel' K3 / K4, 'outside' K7 then K5 / K6. CUDA tensors
    go through the Hopper kernels, CPU tensors through their fp32 plain versions;
    there is no fallback from one to the other. Gradients flow into ``packed.w`` and
    ``packed.b`` when they require one: then the forward kernel writes the stash its
    backward reads. Under ``torch.no_grad`` (the render path) nothing is recorded or
    stashed and the backward kernel never runs."""
    stash = torch.is_grad_enabled() and (packed.w.requires_grad or packed.b.requires_grad)
    return _FusedQuery.apply(packed.w, packed.b, packed, pts, viewdirs, resolve_pe_mode(pe_mode),
                             stash)
