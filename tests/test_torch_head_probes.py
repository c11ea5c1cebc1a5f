"""dmnerf_tpu_torch.kernels.head_probes on the CPU: the plain versions of the head probes
K9 and K10 against the JAX probes' own Pallas kernels (scripts/dev/head512_probe.py's
``kernel``, scripts/dev/mfu_probe4.py's ``k_headsnew``, in interpret mode), bit for bit on
dyadic inputs (where every fp32 sum is exact in any order) and within tolerance on random
ones; K10's operands through the port's ``_pack`` against the JAX package's; the kernels'
layer tables read by a plain interpreter; and the guards: no fallback either way, no JAX
import, shapes refused.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py."""

import ast
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from dmnerf_tpu.core.mlp import init_dm_nerf  # noqa: E402
from dmnerf_tpu.kernels import fused_mlp as jfm  # noqa: E402
from dmnerf_tpu_torch.core import mlp as tmlp  # noqa: E402
from dmnerf_tpu_torch.kernels import fused_mlp as tfm  # noqa: E402
from dmnerf_tpu_torch.kernels import head_probes as hpr  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 128
P = 256
E = 27          # the viewdir embedding's width (multires_views 4)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hp():
    """scripts/dev/head512_probe.py as a module: its import builds nothing."""
    return _load(("scripts", "dev", "head512_probe.py"), "head512_probe")


def _probe4(ops):
    """``k_headsnew`` and ``new_head`` of scripts/dev/mfu_probe4.py, taken out of its
    source with ``ast`` (importing it builds the probe's full-size arrays and times a
    compiled TPU call) and run with the JAX ``fused_mlp``, H and the operands given."""
    path = os.path.join(REPO, "scripts", "dev", "mfu_probe4.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("k_headsnew", "new_head")]
    assert [n.name for n in body] == ["k_headsnew", "new_head"]
    ns = dict(FM=jfm, jax=jax, jnp=jnp, H=(ops["M1b"].shape[1] - 1) // 2, **ops)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns["k_headsnew"], ns["new_head"]


# ---- inputs ----

def _k9_inputs(mode, W, seed, dyadic):
    """x [P, W], 8 trunk weights [W, W], the head [W, 2W (+1)] and wd [1, W] (b, d), as
    bf16-valued numpy arrays: dyadic (x = k/4, |k| <= 4; trunk in {-1, 0, 1}/8; head and
    wd k/16, |k| <= 8) or the probe's normals (weights * 0.05)."""
    rng = np.random.RandomState(seed)
    heads = 2 * W + (mode == "a")

    def arr(shape, scale, k):
        a = rng.randint(-k, k + 1, shape) * scale if dyadic else rng.randn(*shape) * scale
        return np.asarray(jnp.asarray(a.astype(np.float32), jnp.bfloat16).astype(jnp.float32))
    x = arr((P, W), 0.25 if dyadic else 1.0, 4)
    ws = [arr((W, W), 0.125 if dyadic else 0.05, 1) for _ in range(8)]
    ws.append(arr((W, heads), 1 / 16 if dyadic else 0.05, 8))
    wd = arr((1, W), 1 / 16 if dyadic else 0.05, 8) if mode in "bd" else None
    return x, ws, wd


def _k9_probe(hp, mode, x, ws, wd):
    """The JAX probe's kernel in interpret mode at P points, tile 128."""
    ops = [jnp.asarray(w, jnp.bfloat16) for w in ws + ([wd] if mode == "b" else [])]
    W = x.shape[1]
    out = pl.pallas_call(
        functools.partial(hp.kernel, mode),
        out_shape=jax.ShapeDtypeStruct((P, 32), jnp.float32),
        grid=(P // TILE,),
        in_specs=[pl.BlockSpec((TILE, W), lambda i: (i, 0))]
        + [pl.BlockSpec(w.shape, lambda i: (0, 0)) for w in ops],
        out_specs=pl.BlockSpec((TILE, 32), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(x, jnp.bfloat16), *ops)
    return np.asarray(out)


def _torch_k9(x, ws, wd):
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    return t(x), [t(w) for w in ws], None if wd is None else t(wd)


def _k10_dyadic(W, C, seed):
    """h, edT and K10's operands on dyadic grids (h, edT k/4; weights k/16; biases k/8),
    bf16-valued, M2 block-diagonal."""
    rng = np.random.RandomState(seed)
    H = W // 2
    k = lambda shape, s, n=4: (rng.randint(-n, n + 1, shape) * s).astype(np.float32)  # noqa: E731
    m2 = np.zeros((2 * H, 3 + C), np.float32)
    m2[:H, :3], m2[H:, 3:] = k((H, 3), 1 / 16, 8), k((H, C), 1 / 16, 8)
    return dict(h=k((P, W), 0.25), edT=k((E, P), 0.25), m1=k((W, 2 * H + 1), 1 / 16, 8),
                b1=k((1, 2 * H + 1), 0.125), wrh2=k((E, H), 1 / 16, 8), m2=m2,
                b2=k((1, 3 + C), 0.125))


def _k10_random(W, ins_num, seed):
    """The probe's inputs at width W: h and edT standard normals in bf16, the operands of
    ``init_dm_nerf`` through the JAX ``_pack`` as the probe builds them (M1, Wrh2, M2 in
    bf16, the biases fp32)."""
    jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=ins_num, D=2, W=W)
    ops = _jax_operands(jp)
    rng = np.random.RandomState(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return dict(h=bf(rng.randn(P, W).astype(np.float32)),
                edT=bf(rng.randn(E, P).astype(np.float32)),
                m1=bf(ops["m1"]), b1=ops["b1"], wrh2=bf(ops["wrh2"]), m2=bf(ops["m2"]),
                b2=ops["b2"])


def _jax_operands(jp):
    """K10's operands from JAX parameters through the JAX ``_pack`` (``mfu_probe4.py:
    44-57``): M1, b1 [1, 2H+1], Wrh2, M2 block-diagonal, b2 [1, 3+C], fp32 numpy."""
    flat = [np.asarray(a) for a in jfm._pack(jp, 10, 4, 2, (4,))]
    m1, b1, wrh2, _, wro, bro, wio, bio = flat[4:]
    H = wro.shape[0]
    m2 = np.zeros((2 * H, 3 + wio.shape[1]), np.float32)
    m2[:H, :3], m2[H:, 3:] = wro, wio
    return dict(m1=m1, b1=b1, wrh2=wrh2, m2=m2, b2=np.concatenate([bro, bio], axis=1))


def _k10_probe(ops):
    """k_headsnew in interpret mode at P points, tile 128, and new_head: (row sums,
    columns)."""
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)   # noqa: E731
    hops = dict(M1b=bf(ops["m1"]), b1=jnp.asarray(ops["b1"]), Wrh2b=bf(ops["wrh2"]),
                M2b=bf(ops["m2"]), b2=jnp.asarray(ops["b2"]))
    k_headsnew, new_head = _probe4(hops)
    order = [hops[k] for k in ("M1b", "b1", "Wrh2b", "M2b", "b2")]
    W = ops["h"].shape[1]
    rs = pl.pallas_call(
        k_headsnew,
        out_shape=jax.ShapeDtypeStruct((P, 1), jnp.float32),
        grid=(P // TILE,),
        in_specs=[pl.BlockSpec((TILE, W), lambda i: (i, 0)),
                  pl.BlockSpec((E, TILE), lambda i: (0, i))]
        + [pl.BlockSpec(o.shape, lambda i: (0, 0)) for o in order],
        out_specs=pl.BlockSpec((TILE, 1), lambda i: (i, 0)),
        interpret=True,
    )(bf(ops["h"]), bf(ops["edT"]), *order)
    cols = new_head(bf(ops["h"]), bf(ops["edT"]))
    return np.asarray(rs), np.asarray(cols)


def _torch_k10(ops):
    return [torch.from_numpy(np.array(ops[k]))
            for k in ("h", "edT", "m1", "b1", "wrh2", "m2", "b2")]


# ---- K9: the plain version against the probe's kernel ----

@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("mode", ["a", "b", "c"])
def test_head512_ref_matches_the_probe_bit_for_bit_on_dyadic_inputs(hp, mode, W):
    """Where every fp32 sum is exact in any order the plain version (bf16 roundings) is
    the probe's kernel bit for bit, for two seeds."""
    for seed in (0, 1):
        x, ws, wd = _k9_inputs(mode, W, seed, dyadic=True)
        want = _k9_probe(hp, mode, x, ws, wd)
        got = hpr.head512_ref(mode, *_torch_k9(x, ws, wd))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("mode", ["a", "b", "c"])
def test_head512_ref_matches_the_probe_on_normals(hp, mode, W):
    """On the probe's normal inputs within 5e-3 * max(scale, 1): a bf16 rounding that
    flips under another fp32 summation order runs through the later layers."""
    x, ws, wd = _k9_inputs(mode, W, 2, dyadic=False)
    want = _k9_probe(hp, mode, x, ws, wd)
    got = hpr.head512_ref(mode, *_torch_k9(x, ws, wd)).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 5e-3 * max(scale, 1.0)
    assert np.abs(got - want).max() <= 5e-3 * scale


def test_head512_ref_modes_and_store_all():
    """Mode d is b's function; ``store_all`` holds the whole head (sigma last in b, d),
    whose first columns are the probe's output; the fp32 version rounds nothing."""
    x, ws, wd = _torch_k9(*_k9_inputs("b", 32, 3, dyadic=False))
    b, d = hpr.head512_ref("b", x, ws, wd), hpr.head512_ref("d", x, ws, wd)
    assert torch.equal(b, d) and b.shape == (P, 32)
    full = hpr.head512_ref("b", x, ws, wd, store_all=True)
    assert full.shape == (P, 65)
    assert torch.equal(full[:, :31], b[:, :31]) and torch.equal(full[:, 64], b[:, 31])
    h = x
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    torch.testing.assert_close(hpr.head512_ref("b", x, ws, wd, torch.float32, True),
                               torch.cat([h @ ws[-1], (h * wd).sum(1, keepdim=True)], 1))


# ---- K10: the plain version against the probe's kernel ----

@pytest.mark.parametrize("split", [False, True])
def test_heads_fused_ref_matches_k_headsnew_bit_for_bit_on_dyadic_inputs(split):
    """Row sums and columns of both variants against the probe's kernel and new_head, on
    dyadic inputs (W 64, C 9): bit for bit."""
    for seed in (0, 1):
        ops = _k10_dyadic(64, 9, seed)
        want_rs, want_cols = _k10_probe(ops)
        rs, cols = hpr.heads_fused_ref(*_torch_k10(ops), split=split)
        np.testing.assert_array_equal(rs.numpy(), want_rs)
        np.testing.assert_array_equal(cols.numpy(), want_cols)


@pytest.mark.parametrize("split", [False, True])
def test_heads_fused_ref_matches_k_headsnew_on_the_model(split):
    """With init_dm_nerf's operands (W 64, H 32, ins_num 8) and normal h, edT: the row
    sums within 2e-5 of their scale, the columns within 2e-5 of new_head's."""
    ops = _k10_random(64, 8, 0)
    want_rs, want_cols = _k10_probe(ops)
    rs, cols = hpr.heads_fused_ref(*_torch_k10(ops), split=split)
    scale = float(np.abs(want_rs).max())
    assert np.abs(rs.numpy() - want_rs).max() <= 2e-5 * scale
    np.testing.assert_allclose(cols.numpy(), want_cols, atol=2e-5 * np.abs(want_cols).max(),
                               rtol=2e-5)


def test_heads_operands_match_the_jax_pack():
    """``heads_operands`` (the port's ``_pack``) and the probe's construction over the
    JAX ``_pack`` give the same operands from the same parameters (W 64, ins_num 8)."""
    jp = init_dm_nerf(jax.random.PRNGKey(3), ins_num=8, D=2, W=64)
    want = _jax_operands(jp)
    got = hpr.heads_operands(tmlp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                                    device="cpu"), 4)
    assert got["m1"].shape == (64, 65) and got["m2"].shape == (64, 12)
    for k in ("m1", "b1", "wrh2", "m2", "b2"):
        np.testing.assert_allclose(got[k].numpy(), want[k].reshape(got[k].shape),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
    # the split's weights are M2's diagonal blocks: _pack's rgb_out and ins_out
    m2 = got["m2"].numpy()
    np.testing.assert_array_equal(m2[:32, :3], np.asarray(jp["rgb_out_w"]))
    np.testing.assert_array_equal(m2[32:, 3:], np.asarray(jp["ins_out_w"]))
    assert not m2[:32, 3:].any() and not m2[32:, :3].any()


# ---- the kernels' tables, read by a plain interpreter ----

def _interpret_probe(ops, x, edT=None):
    """A plain fp32 reading of ``_probe_plan``'s tables as csrc/fused_mlp_fwd.cuh's
    ROWS_H walk reads them: per layer, its chunks in order, each a box of [rows of N, 64
    columns of K] of the transposed bf16 weights (zeros outside the map) times the
    matching 64 columns of its A (the ed tile, or the registers' h: all of it, or its
    first or last 128 columns), then its epilogue: ReLU into h (bf16), sigma (column 0,
    or the dot of h with the layer's row), or its columns written or summed."""
    plan = hpr._probe_plan(ops)
    n_layers, _, _, kind, pitch, edp = plan["header"][:6]
    wt, b = ops.wt.float(), ops.b
    h = x.float()
    ed = torch.zeros(x.shape[0], 64)
    if edT is not None:
        ed[:, :edT.shape[0]] = edT.float().t()
    out = torch.zeros(x.shape[0], 1 if kind == hpr._OUT_ROWSUM else pitch)
    chunks = iter(plan["chunks"])
    sigma = None
    a_cols = {"ed": (0,), "h": (0, 64, 128, 192), "h_lo": (0, 64), "h_hi": (128, 192)}
    for segs, N, b_off, epi, o_col, o_n, sig in plan["layers"]:
        acc = torch.zeros(x.shape[0], 256)
        for src in ("ed", "h", "h_lo", "h_hi"):
            if not segs & hpr._PSEG[src]:
                continue
            for a0 in a_cols[src]:
                m, k0 = next(chunks)
                off, cols, rows, pitch_w = plan["maps"][m]
                box = torch.zeros(256, 64)
                n = max(0, min(64, cols - k0))
                for r in range(rows):
                    box[r, :n] = wt[off + r * pitch_w + k0: off + r * pitch_w + k0 + n]
                acc += (ed if src == "ed" else h)[:, a0:a0 + 64] @ box.t()
        if epi == hpr._PEPI["relu"]:
            h = torch.relu(acc[:, :N] + b[b_off:b_off + N]).to(torch.bfloat16).float()
            h = torch.nn.functional.pad(h, (0, 256 - N))
            continue
        if epi == hpr._PEPI["sigma"]:
            vals = (acc[:, 0] + b[b_off])[:, None]
            sigma = vals[:, 0]
        elif epi == hpr._PEPI["dot"]:
            vals = (h * b[b_off:b_off + 256]).sum(1, keepdim=True)
            sigma = vals[:, 0]
        else:
            vals = acc[:, :o_n] + b[b_off:b_off + o_n]
            if sig >= 0:
                vals[:, sig] = sigma
        vals = vals[:, :o_n]
        if kind == hpr._OUT_ROWSUM:
            out[:, 0] += vals.sum(1)
        else:
            out[:, o_col:o_col + o_n] = vals
    assert next(chunks, None) is None and len(plan["layers"]) == n_layers
    assert all(off % 8 == 0 and pitch_w % 8 == 0 and 0 < rows <= 256
               for off, _, rows, pitch_w in plan["maps"])
    return out


@pytest.mark.parametrize("mode", hpr.H512_MODES)
def test_head512_tables_interpret_to_the_plain_version(mode):
    """K9's tables, with the probe's window and with ``store_all``, read by the
    interpreter at the kernel's width (256) on dyadic inputs: the bf16 plain version
    within 1e-6 of its scale (at this width a few sums are not exact); every head column
    is a pass of the table (two, or three in mode a)."""
    x, ws, wd = _torch_k9(*_k9_inputs(mode, 256, 4, dyadic=True))
    x = x[:64]
    for store_all in (False, True):
        ops = hpr.head512_operands(mode, ws, wd, store_all)
        passes = [L for L in ops.layers if L.epi == "cols"]
        assert [L.o_col for L in passes] == ([0, 256, 512] if mode == "a" else [0, 256])
        got = _interpret_probe(ops, x)
        want = hpr.head512_ref(mode, x, ws, wd, store_all=store_all)
        assert got.shape == want.shape
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("split", [False, True])
def test_heads_fused_tables_interpret_to_the_plain_version(split):
    """K10's tables (sigma, the head over [ed | h], the block-diagonal output or the
    rgb / ins pair over h's halves), row sums and ``store_all`` columns, read by the
    interpreter at W 256 on dyadic inputs: the bf16 plain version within 1e-6 of its
    scale."""
    ops = _k10_dyadic(256, 33, 5)
    h, edT, m1, b1, wrh2, m2, b2 = _torch_k10(ops)
    h, edT = h[:64], edT[:, :64]
    rs, cols = hpr.heads_fused_ref(h, edT, m1, b1, wrh2, m2, b2, split)
    for store_all, want in ((False, rs), (True, cols)):
        carried = hpr.heads_fused_operands(m1, b1, wrh2, m2, b2, split, store_all)
        assert [L.epi for L in carried.layers] == ["sigma", "relu"] + ["cols"] * (1 + split)
        assert carried.rowsum == (not store_all)
        got = _interpret_probe(carried, h, edT)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


def test_probe_operands_layout():
    """Every block is its weight transposed to [N, K] in bf16, N padded to 16 with zero
    rows, 128-byte aligned; the split's rgb block carries sigma's zero column 3; mode a's
    513th column is an n16 pass."""
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(256, 256, generator=g) for _ in range(8)] + [torch.randn(256, 513, generator=g)]
    ops = hpr.head512_operands("a", ws)
    last = ops.layers[-1]
    assert (last.N, last.K, last.o_col) == (16, 256, 512)
    blk = ops.wt[last.w_off:last.w_off + 16 * 256].view(16, 256)
    assert torch.equal(blk[0], ws[-1][:, 512].to(torch.bfloat16)) and not blk[1:].any()
    assert all(L.w_off % 64 == 0 for L in ops.layers)
    t = _torch_k10(_k10_dyadic(256, 33, 0))
    split = hpr.heads_fused_operands(*t[2:], split=True)
    rgb, ins = split.layers[2:]
    assert (rgb.N, rgb.K, rgb.sig_col, ins.N, ins.o_col, ins.o_n) == (16, 128, 3, 48, 4, 33)
    rgb_blk = split.wt[rgb.w_off:rgb.w_off + 16 * 128].view(16, 128).float()
    assert torch.equal(rgb_blk[:3], t[5][:128, :3].t()) and not rgb_blk[3:].any()
    one = hpr.heads_fused_operands(*t[2:])
    assert (one.layers[2].N, one.layers[2].sig_col, one.layers[2].o_n) == (48, 3, 37)


# ---- guards ----

def _meta(*ts):
    return [t.to("meta") for t in ts]


def test_card_tensors_take_the_kernel_or_raise(monkeypatch):
    """No fallback: tensors that are not on the CPU go to the kernel; when it cannot be
    built the call raises, no launch counted and no plain version run."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))

    def no_build(name):
        raise RuntimeError(f"kernel build failed: {name}")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(runtime, "load", no_build)
    monkeypatch.setattr(hpr, "head512_ref", no_plain)
    monkeypatch.setattr(hpr, "heads_fused_ref", no_plain)
    runtime.reset_launches()
    for mode in hpr.H512_MODES:
        x, ws, wd = _torch_k9(*_k9_inputs(mode, 256, 0, dyadic=False))
        x = x.to(torch.bfloat16)
        with pytest.raises(RuntimeError, match="kernel build failed: head512"):
            hpr.head512(mode, *_meta(x), _meta(*ws), *(() if wd is None else _meta(wd)))
    t = _torch_k10(_k10_dyadic(256, 33, 0))
    t[0], t[1] = t[0].to(torch.bfloat16), t[1].to(torch.bfloat16)
    for split in (False, True):
        with pytest.raises(RuntimeError, match="kernel build failed: heads_fused"):
            hpr.heads_fused(*_meta(*t), split=split)
    assert not any(runtime.LAUNCHES.values())


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors never reach the kernel: the fp32 plain versions answer."""
    def no_kernel(*a, **k):
        raise AssertionError("a kernel was launched for a CPU tensor")

    monkeypatch.setattr(hpr, "_launch_probe", no_kernel)
    monkeypatch.setattr(runtime, "load", no_kernel)
    x, ws, wd = _torch_k9(*_k9_inputs("d", 32, 0, dyadic=False))
    assert torch.equal(hpr.head512("d", x, ws, wd),
                       hpr.head512_ref("d", x, ws, wd, torch.float32))
    t = _torch_k10(_k10_random(64, 8, 1))
    assert torch.equal(hpr.heads_fused(*t, split=True),
                       hpr.heads_fused_ref(*t, split=True, act_dtype=torch.float32)[0])
    assert torch.equal(hpr.heads_fused(*t, store_all=True),
                       hpr.heads_fused_ref(*t, act_dtype=torch.float32)[1])


def test_wrappers_refuse_wrong_shapes(monkeypatch):
    """Shapes that the probes or the kernels do not take are refused before any build."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    x, ws, wd = _torch_k9(*_k9_inputs("b", 32, 0, dyadic=False))
    with pytest.raises(ValueError, match="mode must be"):
        hpr.head512("e", x, ws)
    with pytest.raises(ValueError, match="wd"):
        hpr.head512("b", x, ws)
    with pytest.raises(ValueError, match="head"):
        hpr.head512("a", x, ws)
    # the kernel holds W = 256 only
    with pytest.raises(ValueError, match=r"\[P, 256\]"):
        hpr.head512("b", *_meta(x.to(torch.bfloat16)), _meta(*ws), *_meta(wd))
    t = _torch_k10(_k10_random(64, 8, 0))
    with pytest.raises(ValueError, match="edT"):
        hpr.heads_fused(t[0], t[1][:, :-1], *t[2:])
    t[0], t[1] = t[0].to(torch.bfloat16), t[1].to(torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[P, 256\]"):
        hpr.heads_fused(*_meta(*t))


def test_head_probes_import_no_jax():
    """The new modules import neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import dmnerf_tpu_torch.kernels.head_probes\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'dmnerf_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr


# ---- the consumers' schedule each probe takes (csrc/fused_mlp_fwd.cuh Sched) ----

# digests of the probe tables at the probes' shapes (K9 W 256, heads 512 / 513; K10 of the
# flagship's operands, ins_num 32) as they were before the template had a schedule
PROBE_TABLES = {"a": "fb3cd0782833400b", "b": "23ba0c018779f858", "c": "360f360454d86dc8",
                "d": "6326e6c7084321e6", "block_diagonal": "0ec5625bfc380683",
                "split": "88cf166ff97a98db"}


def test_probes_take_their_schedules(monkeypatch):
    """K10's launch asks for pipelined products (``HEADS_FUSED_SCHEDULE``) and K9's
    takes no schedule (its source builds lockstep), over the tables they received before,
    element by element; a schedule an entry does not take is refused before any launch."""
    from test_torch_fused_render import _digest, recording_loader

    calls = []
    recording_loader(monkeypatch, calls, {"head512": 7, "heads_fused": 7}, layer_row=7)
    meta = lambda *ts: [t.to("meta") for t in ts]   # noqa: E731
    for mode in hpr.H512_MODES:
        ws = [torch.zeros(256, 256) for _ in range(8)] + [torch.zeros(256, 512 + (mode == "a"))]
        wd = torch.zeros(1, 256) if mode in "bd" else None
        hpr.head512(mode, *meta(torch.zeros(4, 256, dtype=torch.bfloat16)), meta(*ws),
                    *(() if wd is None else meta(wd)))
    params = tmlp.init_dm_nerf(ins_num=32, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    ops = hpr.heads_operands(params, 4)
    h, edT = torch.zeros(4, 256, dtype=torch.bfloat16), torch.zeros(27, 4, dtype=torch.bfloat16)
    for split in (False, True):
        hpr.heads_fused(*meta(h, edT, *(ops[k] for k in ("m1", "b1", "wrh2", "m2", "b2"))),
                        split=split)
    got = [(name, len(args), args[-1], _digest(table)) for name, args, table in calls]
    assert hpr.HEADS_FUSED_SCHEDULE == tfm.PIPELINED == 1
    # K9: ten arguments, the last the stream (0); K10: eleven, the last the schedule
    assert got == [("head512", 10, 0, PROBE_TABLES[m]) for m in hpr.H512_MODES] + [
        ("heads_fused", 11, tfm.PIPELINED, PROBE_TABLES[v]) for v in ("block_diagonal", "split")]
    probe_ops = hpr.heads_fused_operands(*meta(*(ops[k] for k in ("m1", "b1", "wrh2", "m2",
                                                                   "b2"))))
    hpr._launch_probe("heads_fused", probe_ops, *meta(h, edT), tfm.LOCKSTEP)
    assert calls[-1][1][-1] == tfm.LOCKSTEP
    with pytest.raises(ValueError, match="schedule"):
        hpr._launch_probe("heads_fused", probe_ops, *meta(h, edT), 2)
    h512_ops = hpr.head512_operands("c", [torch.zeros(256, 256)] * 8 + [torch.zeros(256, 512)])
    with pytest.raises(ValueError, match="schedule"):
        hpr._launch_probe("head512", h512_ops, *meta(h), None, tfm.PIPELINED)
    assert len(calls) == 7


def test_probe_plan_refuses_output_columns_past_a_layer():
    """An output window wider than its layer is refused by the plan: the pipelined
    schedule computes columns past a layer's N from stage rows past its box, so no
    epilogue may read them."""
    params = tmlp.init_dm_nerf(ins_num=32, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    ops = hpr.heads_operands(params, 4)
    probe_ops = hpr.heads_fused_operands(*(ops[k] for k in ("m1", "b1", "wrh2", "m2", "b2")),
                                         store_all=True)
    hpr._probe_plan(probe_ops)
    i = next(i for i, L in enumerate(probe_ops.layers) if L.epi == "cols")
    wide = dataclasses.replace(probe_ops.layers[i], o_n=probe_ops.layers[i].N + 1)
    bad = dataclasses.replace(probe_ops, layers=probe_ops.layers[:i] + (wide,)
                              + probe_ops.layers[i + 1:])
    with pytest.raises(ValueError, match="columns"):
        hpr._probe_plan(bad)
