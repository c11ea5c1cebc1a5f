"""The fused PE + DM-NeRF MLP forward for one point query: a hand-written Hopper
kernel (``csrc/fused_mlp_fwd.cu``), its plain PyTorch version, the wrapper that
picks between them, and the host-side packing both consume.

It computes what the JAX package's ``_fwd_kernel_pet`` computes
(``dmnerf_tpu/kernels/fused_mlp.py:507``): the point embedding
``[x | sin(2^f x) | cos(2^f x)]`` in fp32, the ReLU trunk with the embedding
re-injected at each skip layer, and the fused head

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
the same product as the full model's. Embedding widths pad to multiples of 16
(63 -> 64, 27 -> 32), head widths are runtime values (Hr = Hi = 8 and C = 1 for the
sigma stub).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dmnerf_tpu_torch.kernels import runtime

Params = dict

# activation row layout and tiling of csrc/fused_mlp_fwd.cu
_ACT_COLS = 352        # widest [ed | h | e] row the kernel holds
_N_MAX = 256           # widest layer output the kernel holds
_MAX_LAYERS = 20
_EPI = {"sigma": 1, "out": 2}   # every other layer: ReLU into h


# ---------------------------------------------------------------------------
# Host-side packing (dmnerf_tpu/kernels/fused_mlp.py:98-180)
# ---------------------------------------------------------------------------

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
    permp = torch.as_tensor(_emb_perm(multires))
    permd = torch.as_tensor(_emb_perm(multires_views))
    emb = _emb_dim(multires)
    out: List[torch.Tensor] = []
    for i, kind in enumerate(_layer_kinds(D, skips)):
        w, b = params[f"trunk_{i}_w"], params[f"trunk_{i}_b"][None, :]
        if kind == "emb0":
            out += [w[permp.to(w.device)], b]
        elif kind == "split":
            hs = w.shape[0] - emb
            out += [torch.cat([w[:hs], w[hs:][permp.to(w.device)]], dim=0), b]
        else:
            out += [w, b]
    wrh = params["rgb_hid_w"]
    hsd = wrh.shape[0] - _emb_dim(multires_views)
    wrh1, wrh2 = wrh[:hsd], wrh[hsd:][permd.to(wrh.device)]
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
    w_bf16: torch.Tensor     # the same, in bf16, as the kernel reads them
    b: torch.Tensor          # flat fp32 biases
    layers: Tuple[Layer, ...]
    multires: int
    multires_views: int
    width: int               # W
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

    layers, ws, bs = [], [], []
    w_off = b_off = 0
    for kind, a_col, w, b in entries:
        K, N = w.shape
        layers.append(Layer(kind, a_col, K, N, w_off, b_off))
        pad_w = _round_up(K * N, 64) - K * N    # keep every block 128-byte aligned
        ws += [w.reshape(-1).float(), zeros(pad_w)]
        bs.append(b.float())
        w_off += K * N + pad_w
        b_off += N
    w = torch.cat(ws)
    return Packed(w=w, w_bf16=w.to(torch.bfloat16), b=torch.cat(bs), layers=tuple(layers),
                  multires=multires, multires_views=multires_views, width=W,
                  ep=ep, edp=edp, c4=c4)


# ---------------------------------------------------------------------------
# Embeddings in kernel lane order
# ---------------------------------------------------------------------------

def _embedding(x: torch.Tensor, multires: int, width: int) -> torch.Tensor:
    """[x | sin(x @ F) | cos(x @ F) | 0 pad] in fp32, F = _freq_matrix: lane f*3+c
    holds x_c * 2^f. The product is taken lane by lane, not as a matmul, so it is
    exact whatever the matmul precision: a rounded phase at 2^9 |x| is an O(1) error."""
    F = torch.from_numpy(_freq_matrix(multires, x.shape[-1])).to(x.device)
    xs = x[:, F.argmax(dim=0)] * F.amax(dim=0)
    e = torch.cat([x, torch.sin(xs), torch.cos(xs)], dim=-1)
    return torch.nn.functional.pad(e, (0, width - e.shape[-1]))


def view_embedding(packed: Packed, viewdirs: torch.Tensor) -> torch.Tensor:
    """The per-ray viewdir embedding [N, EDP] the kernel reads, fp32."""
    return _embedding(viewdirs, packed.multires_views, packed.edp)


# ---------------------------------------------------------------------------
# Plain version and wrapper
# ---------------------------------------------------------------------------

def fused_query_ref(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                    act_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in torch ops over the same packed layout.

    pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4+C] fp32. With
    ``act_dtype=float32`` this is the CPU path and the fp32 yardstick. With
    ``bfloat16`` it rounds embeddings, weights and post-ReLU activations to bf16
    where the kernel does and keeps fp32 products and sums, so it differs from the
    kernel only in the order of the fp32 sums (run it with TF32 off)."""
    N, S, _ = pts.shape
    if act_dtype == torch.float32:
        def rnd(t):
            return t
    else:
        def rnd(t):
            return t.to(act_dtype).float()
    w_all = packed.w if act_dtype == torch.float32 else packed.w_bf16.float()
    x = pts.reshape(N * S, 3).float()
    e = rnd(_embedding(x, packed.multires, packed.ep))
    ed = rnd(view_embedding(packed, viewdirs.float())).repeat_interleave(S, dim=0)
    h = sigma = None
    for layer in packed.layers:
        w = w_all[layer.w_off:layer.w_off + layer.K * layer.N].view(layer.K, layer.N)
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
            return out[:, :packed.c4].reshape(N, S, packed.c4)
        h = rnd(torch.relu(a @ w + b))
    raise ValueError("packed layer table has no output layer")


def _check_kernel_inputs(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor) -> None:
    dev = pts.device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"fused_mlp_fwd is built for sm_90a; device {dev} is "
                           f"sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")
    for name, t, dt in (("pts", pts, torch.float32), ("viewdirs", viewdirs, torch.float32),
                        ("packed.w_bf16", packed.w_bf16, torch.bfloat16),
                        ("packed.b", packed.b, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if pts.dim() != 3 or pts.shape[-1] != 3 or viewdirs.shape != (pts.shape[0], 3):
        raise ValueError(f"want pts [N, S, 3] and viewdirs [N, 3], got "
                         f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}")
    if packed.edp + packed.width + packed.ep > _ACT_COLS or packed.width % 16:
        raise ValueError(f"kernel holds [ed | h | e] rows of at most {_ACT_COLS} columns with "
                         f"W % 16 == 0; got {packed.edp} + {packed.width} + {packed.ep}")
    if len(packed.layers) > _MAX_LAYERS:
        raise ValueError(f"kernel takes at most {_MAX_LAYERS} layers, got {len(packed.layers)}")
    for layer in packed.layers:
        if layer.K % 16 or layer.N % 16 or layer.N > _N_MAX \
                or layer.a_col + layer.K > _ACT_COLS or packed.edp + layer.N > _ACT_COLS:
            raise ValueError(f"kernel wants K, N multiples of 16, N <= {_N_MAX} and rows "
                             f"within {_ACT_COLS} activation columns: {layer}")


def fused_query(packed: Packed, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """Point query pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4+C] fp32.

    CUDA tensors go through the Hopper kernel, CPU tensors through the fp32 plain
    version; there is no fallback from one to the other. Forward only: parameters
    that require a gradient are refused."""
    if packed.w.requires_grad or packed.b.requires_grad:
        raise ValueError("fused_query is forward-only; its parameters require a gradient")
    if pts.device.type == "cpu":
        return fused_query_ref(packed, pts, viewdirs, torch.float32)
    _check_kernel_inputs(packed, pts, viewdirs)
    N, S, _ = pts.shape
    P = N * S
    edr = view_embedding(packed, viewdirs).to(torch.bfloat16).contiguous()
    out = torch.empty((P, packed.c4), dtype=torch.float32, device=pts.device)
    if P == 0:
        return out.reshape(N, S, packed.c4)
    table = []
    for layer in packed.layers:
        table += [layer.a_col, layer.K, layer.N, layer.w_off, layer.b_off, _EPI.get(layer.kind, 0)]
    c_table = (ctypes.c_int * len(table))(*table)
    lib = runtime.load("fused_mlp_fwd")
    fn = lib.dmnerf_fused_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(pts.data_ptr(), edr.data_ptr(), packed.w_bf16.data_ptr(), packed.b.data_ptr(),
             out.data_ptr(), P, S, c_table, len(packed.layers), packed.multires,
             packed.edp, packed.edp + packed.width, packed.ep, packed.c4,
             torch.cuda.current_stream(pts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {err}")
    runtime.LAUNCHES["fused_mlp_fwd"] += 1
    return out.reshape(N, S, packed.c4)
