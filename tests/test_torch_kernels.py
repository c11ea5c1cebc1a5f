"""dmnerf_tpu_torch.kernels.fused_mlp on the CPU: packing vs the JAX _pack; for each
pe_mode (its route in ``ROUTES``) the forward kernels' fp32 plain version vs the Pallas
query of that mode (interpret mode) and the XLA query at 2e-5 on the CASES of
tests/test_kernels.py, the backward's plain version vs the Pallas backward (jax.grad
through the interpret-mode kernels) and vs autograd of the plain PyTorch query at atol
3e-5 / rtol 3e-4 (tests/test_kernels.py:64-71), the instance-head gradient wall, the
stubs' exact columns, and the three modes' plain queries against each other; and the
guards: no JAX import, no fallback, gradients that flow only when asked for, no silent
CPU. The tables the backward kernels read (and the stash layout the training forward
writes) are held to the plain backward through a plain interpreter of them.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.core.mlp import init_dm_nerf, rgb_stub_params, sigma_stub_params  # noqa: E402
from dmnerf_tpu.core.pipeline import make_xla_query_fn  # noqa: E402
from dmnerf_tpu.kernels import fused_mlp as jfm  # noqa: E402
from dmnerf_tpu_torch.core import mlp as tmlp  # noqa: E402
from dmnerf_tpu_torch.core.pipeline import make_fused_query_fn, make_torch_query_fn  # noqa: E402
from dmnerf_tpu_torch.kernels import fused_mlp as tfm  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-5, rtol=3e-4)
CASES = [
    # (multires, multires_views, D, W, skips, ins_num), as tests/test_kernels.py
    (4, 2, 2, 32, (0,), 4),
    (10, 4, 8, 64, (4,), 8),
    (6, 3, 5, 32, (1, 3), 4),
]
MODES = ["kernel_t", "kernel", "outside"]


def _setup(multires, multires_views, D, W, skips, ins_num, N=6, S=8, seed=0):
    jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=ins_num, D=D, W=W,
                      input_ch_pts=3 * (1 + 2 * multires),
                      input_ch_views=3 * (1 + 2 * multires_views), skips=skips)
    rng = np.random.RandomState(seed)
    pts = rng.randn(N, S, 3).astype(np.float32)
    dirs = rng.randn(N, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jp, pts, dirs


def _torch(jp):
    return tmlp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_pack_equals_jax_pack(case):
    mr, mrv, D, W, skips, ins = case
    jp, _, _ = _setup(*case)
    want = jfm._pack(jp, mr, mrv, D, skips)
    got = tfm._pack(_torch(jp), mr, mrv, D, skips)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(tfm._emb_perm(mr), jfm._emb_perm(mr))
    np.testing.assert_array_equal(tfm._freq_matrix(mr), jfm._freq_matrix(mr))
    assert tfm._layer_kinds(D, skips) == jfm._layer_kinds(D, skips)


def _pallas(mode, mr, mrv, D, skips):
    return jfm.make_pallas_query_fn(mr, mrv, D, skips, tile_fwd=16, tile_bwd=16,
                                    interpret=True, pe_mode=mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_plain_fp32_matches_pallas_and_xla(case, mode):
    """``mode``'s plain version on the CPU (through fused_query, which launches nothing,
    and query_fwd) vs the Pallas query of the same pe_mode in interpret mode and the XLA
    query, at 2e-5; and the layer walk over the JAX package's own point embedding
    (make_pe_pallas) gives the same."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    pts_t, dirs_t = torch.from_numpy(pts), torch.from_numpy(dirs)
    runtime.reset_launches()
    got = tfm.fused_query(packed, pts_t, dirs_t, mode).numpy()
    assert not any(runtime.LAUNCHES.values())
    assert torch.equal(torch.from_numpy(got), tfm.query_fwd(packed, pts_t, dirs_t, mode))
    for q in (_pallas(mode, mr, mrv, D, skips), make_xla_query_fn(mr, mrv, D, skips)):
        want = np.asarray(q(jp, jnp.asarray(pts), jnp.asarray(dirs)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)

    N, S, _ = pts.shape
    e = np.asarray(jfm.make_pe_pallas(mr, jnp.float32, tile=16, interpret=True)(
        jnp.asarray(pts.reshape(-1, 3))))
    e = np.pad(e, ((0, 0), (0, packed.ep - e.shape[1])))
    _, ed = tfm.ROUTES[mode].embeddings(packed, pts_t, dirs_t, torch.float32)
    flat = tfm._walk_fwd(packed, torch.from_numpy(e), ed, torch.float32)
    np.testing.assert_allclose(flat.numpy().reshape(N, S, -1), got, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_modes_compute_one_function(case):
    """The three modes' plain queries agree within 2e-5 at fp32, forward and backward:
    their kernels compute one function and differ only in where the embeddings are
    built."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    pts_t, dirs_t = torch.from_numpy(pts), torch.from_numpy(dirs)
    g = torch.from_numpy(np.random.RandomState(2).randn(*pts.shape[:2], packed.c4)
                         .astype(np.float32))
    raws = {m: tfm.query_fwd(packed, pts_t, dirs_t, m) for m in MODES}
    grads = {m: tfm.query_bwd(packed, pts_t, dirs_t, g, m) for m in MODES}
    for m in MODES[1:]:
        torch.testing.assert_close(raws[m], raws[MODES[0]], **TOL)
        for got, want in zip(grads[m], grads[MODES[0]]):
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_stub_columns_exact(case, mode):
    """The sigma stub's sigma column, and the rgb stub's sigma and instance columns,
    are bit-equal to the full model's under ``mode``, whose query agrees with
    'kernel_t''s in fp32."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    args = (mr, mrv, D, skips)
    pts_t, dirs_t = torch.from_numpy(pts), torch.from_numpy(dirs)

    def query(p, m=mode):
        return tfm.fused_query(tfm.pack_params(_torch(p), *args), pts_t, dirs_t, m)
    full, sig, rgb = query(jp), query(sigma_stub_params(jp)), query(rgb_stub_params(jp))
    assert sig.shape[-1] == 5 and rgb.shape == full.shape
    assert torch.equal(sig[..., 3], full[..., 3])
    assert torch.equal(rgb[..., 3:], full[..., 3:])
    torch.testing.assert_close(full, query(jp, "kernel_t"), atol=1e-6, rtol=1e-6)


def test_bf16_plain_rounds_like_the_kernel():
    """act_dtype=bfloat16 rounds embeddings, weights and activations to bf16: close to
    fp32 at bf16 scale, and exactly the fp32 path when the inputs are bf16-exact."""
    mr, mrv, D, W, skips, ins = CASES[1]
    jp, pts, dirs = _setup(*CASES[1], N=8, S=16)
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    f32 = tfm.query_fwd(packed, p, d, "kernel_t", torch.float32)
    b16 = tfm.query_fwd(packed, p, d, "kernel_t", torch.bfloat16)
    scale = float(f32.abs().max())
    assert 0 < float((b16 - f32).abs().max()) <= 0.03 * scale


def test_packed_layout_pads_to_the_kernel_grid():
    """Flagship widths: K pads 63 -> 64, 27 -> 32 and 256+63 -> 256+64; every block
    starts 128-byte aligned; the head widths follow the params (sigma stub: 8 + 8)."""
    p = tmlp.init_dm_nerf(ins_num=32, device="cpu")
    packed = tfm.pack_params(p, 10, 4, 8, (4,))
    kinds = [(l.kind, l.a_col, l.K, l.N) for l in packed.layers]
    assert kinds == [("emb0", 288, 64, 256)] + [("plain", 32, 256, 256)] * 4 + \
        [("split", 32, 320, 256)] + [("plain", 32, 256, 256)] * 2 + \
        [("sigma", 32, 256, 16), ("head", 0, 288, 256), ("out", 32, 256, 48)]
    assert all(l.w_off % 64 == 0 for l in packed.layers)
    stub = tfm.pack_params(tmlp.sigma_stub_params(p), 10, 4, 8, (4,))
    assert [(l.K, l.N) for l in stub.layers[-2:]] == [(288, 16), (16, 16)]
    assert packed.c4 == 37 and stub.c4 == 5


def test_packed_clone_and_copy_in_place():
    """``Packed.clone`` holds the same values in tensors of its own; ``copy_`` writes
    another model's values into them without moving them (a captured graph keeps their
    addresses), and refuses a model of another layout."""
    a = tfm.pack_params(tmlp.init_dm_nerf(ins_num=32, device="cpu"), 10, 4, 8, (4,))
    g = torch.Generator().manual_seed(1)
    b = tfm.pack_params(tmlp.init_dm_nerf(ins_num=32, device="cpu", generator=g), 10, 4, 8, (4,))
    static = a.clone()
    names = ("w", "w_bf16", "wt_bf16", "b")
    ptrs = [getattr(static, k).data_ptr() for k in names]
    assert all(torch.equal(getattr(static, k), getattr(a, k)) for k in names)
    assert all(p != getattr(a, k).data_ptr() for p, k in zip(ptrs, names))
    assert static.layers == a.layers and static.c4 == a.c4
    static.copy_(b)
    assert all(torch.equal(getattr(static, k), getattr(b, k)) for k in names)
    assert [getattr(static, k).data_ptr() for k in names] == ptrs
    with pytest.raises(ValueError):
        static.copy_(tfm.pack_params(tmlp.init_dm_nerf(ins_num=16, device="cpu"), 10, 4, 8, (4,)))


def test_import_guard():
    """No module of the port, nor chip_smoke.py, imports JAX, orbax or the JAX package."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import dmnerf_tpu_torch\n"
        "for m in pkgutil.walk_packages(dmnerf_tpu_torch.__path__, 'dmnerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('dmnerf_tpu_torch.train', 'dmnerf_tpu_torch.render.trainstep',\n"
        "          'dmnerf_tpu_torch.objfield.losses', 'dmnerf_tpu_torch.objfield.hungarian',\n"
        "          'dmnerf_tpu_torch.objfield.penalizer', 'dmnerf_tpu_torch.data.samplers',\n"
        "          'dmnerf_tpu_torch.data.scannet', 'dmnerf_tpu_torch.data.replica'):\n"
        "    assert m in sys.modules, m\n"
        "from dmnerf_tpu_torch.data.samplers import make_crop_sampler\n"
        "from dmnerf_tpu_torch.kernels import runtime\n"
        "assert runtime.KERNELS == ('fused_mlp_fwd', 'fused_mlp_bwd', 'fused_mlp_fwd_kpe',\n"
        "                           'fused_mlp_bwd_kpe', 'fused_mlp_fwd_pe', 'fused_mlp_bwd_pe',\n"
        "                           'fused_pe', 'fused_render', 'head512', 'heads_fused',\n"
        "                           'assignment', 'instance_terms')\n"
        "assert set(runtime.LAUNCHES) == set(runtime.COUNTED) == (\n"
        "    set(runtime.KERNELS) - {'fused_render', 'instance_terms'}) | {\n"
        "    'fused_render_weights', 'fused_render_maps', 'instance_terms_fwd', 'instance_terms_bwd'}\n"
        "assert all((runtime.CSRC / f'{k}.cu').exists() for k in runtime.KERNELS)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'dmnerf_tpu', 'orbax')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('dmnerf_tpu_torch')]))\n"
    )
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 26


def test_cpu_wrapper_takes_the_plain_version():
    mr, mrv, D, W, skips, ins = CASES[0]
    jp, pts, dirs = _setup(*CASES[0])
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    runtime.reset_launches()
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    got = tfm.fused_query(packed, p, d)
    assert torch.equal(got, tfm.query_fwd(packed, p, d))
    assert torch.equal(got, tfm.query_fwd(packed, p, d, "kernel_t", torch.float32))
    dw, db = tfm.query_bwd(packed, p, d, torch.ones_like(got))
    want_dw, want_db = tfm.query_bwd(packed, p, d, torch.ones_like(got), "kernel_t",
                                     torch.float32)
    assert torch.equal(dw, want_dw) and torch.equal(db, want_db)
    assert not any(runtime.LAUNCHES.values())


def _tanh_loss_grads(query, params, pts, dirs):
    """Parameter gradients of sum(tanh(raw) * w), w = linspace(0.5, 1.5) over the
    channels, so every head contributes (tests/test_kernels.py:56-62)."""
    pp = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    raw = query(pp, torch.from_numpy(pts), torch.from_numpy(dirs))
    w = torch.from_numpy(np.linspace(0.5, 1.5, raw.shape[-1]).astype(np.float32))
    (torch.tanh(raw) * w).sum().backward()
    return {k: v.grad.numpy() for k, v in pp.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas_backward(case, mode):
    """autograd through the fused query on the CPU (``mode``'s plain backward, mapped to
    the parameter dict by autograd over pack_params) vs jax.grad through the Pallas
    backward of the same pe_mode in interpret mode, and vs autograd of the plain
    PyTorch query, at atol 3e-5 / rtol 3e-4."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    q_pal = _pallas(mode, mr, mrv, D, skips)
    w = jnp.asarray(np.linspace(0.5, 1.5, 4 + ins + 1), jnp.float32)
    want = jax.grad(lambda p: jnp.sum(jnp.tanh(q_pal(p, jnp.asarray(pts), jnp.asarray(dirs))) * w))(jp)
    runtime.reset_launches()
    got = _tanh_loss_grads(make_fused_query_fn(mr, mrv, D, skips, mode), _torch(jp), pts, dirs)
    plain = _tanh_loss_grads(make_torch_query_fn(mr, mrv, D, skips), _torch(jp), pts, dirs)
    assert not any(runtime.LAUNCHES.values())
    assert set(got) == set(want) == set(plain)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **GRAD_TOL, err_msg=k)
        np.testing.assert_allclose(got[k], plain[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_instance_gradient_wall(case, mode):
    """An instance-only loss gives exactly zero trunk, rgb and density gradients, and
    a nonzero instance head gradient, through the fused query under ``mode`` (autograd
    over pack_params) and in the packed layout of its plain backward itself, in fp32 and
    in bf16."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    pp = {k: v.requires_grad_(True) for k, v in _torch(jp).items()}
    raw = make_fused_query_fn(mr, mrv, D, skips, mode)(pp, torch.from_numpy(pts),
                                                       torch.from_numpy(dirs))
    raw[..., 4:].sum().backward()
    for k, v in pp.items():
        if k.startswith(("trunk_", "rgb_", "density")):
            assert v.grad is None or int(torch.count_nonzero(v.grad)) == 0, k
    assert float(pp["ins_out_w"].grad.abs().sum()) > 0

    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    g = torch.zeros(raw.shape)
    g[..., 4:] = 1.0
    for dtype in (torch.float32, torch.bfloat16):
        dw, db = tfm.query_bwd(packed, torch.from_numpy(pts), torch.from_numpy(dirs), g, mode,
                               dtype)
        *trunk, sig, head, out = packed.layers
        for layer in (*trunk, sig):
            assert not dw[layer.w_off:layer.w_off + layer.K * layer.N].any(), layer
            assert not db[layer.b_off:layer.b_off + layer.N].any(), layer
        head_w = dw[head.w_off:head.w_off + head.K * head.N].view(head.K, head.N)
        assert not head_w[:, :packed.hr].any() and not db[head.b_off:head.b_off + packed.hr].any()
        assert head_w[packed.edp:, packed.hr:].any()


def test_gradients_flow_and_the_render_path_stays_forward(monkeypatch):
    """Parameters that require a gradient get one through fused_query; under
    torch.no_grad (the render path) nothing is recorded and the backward never runs."""
    mr, mrv, D, W, skips, ins = CASES[0]
    jp, pts, dirs = _setup(*CASES[0])
    params = {k: v.requires_grad_(True) for k, v in _torch(jp).items()}
    packed = tfm.pack_params(params, mr, mrv, D, skips)
    raw = tfm.fused_query(packed, torch.from_numpy(pts), torch.from_numpy(dirs))
    assert raw.requires_grad
    raw.sum().backward()
    assert all(v.grad is not None for v in params.values())

    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.render.renderer import make_image_renderer

    def no_backward(*args, **kwargs):
        raise AssertionError("the render path ran the backward")

    monkeypatch.setattr(tfm, "_walk_bwd", no_backward)
    cfg = Config(netdepth=D, netwidth=W, multires=mr, multires_views=mrv, skips=skips,
                 ins_num=ins, N_samples=6, N_importance=4, N_test=8, near=2.0, far=6.0)
    runtime.reset_launches()
    out = make_image_renderer(cfg)(params, params, torch.zeros(10, 3),
                                   torch.from_numpy(np.tile(dirs[:1], (10, 1))))
    assert not any(v.requires_grad for v in out.values())
    assert not any(runtime.LAUNCHES.values())


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.render.evaluation import render_test
    from dmnerf_tpu_torch.test import init_params, load_params, run_test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(basedir=str(tmp_path), netdepth=2, netwidth=16, multires=2, multires_views=1,
                 skips=(0,), ins_num=2, render=True)
    for call in (lambda: tmlp.init_dm_nerf(ins_num=2, D=2, W=16),
                 lambda: tmlp.params_from_numpy({"a": np.zeros(2, np.float32)}),
                 lambda: init_params(cfg), lambda: load_params(cfg), lambda: run_test(cfg),
                 lambda: render_test(cfg, {}, {}, np.eye(4)[None], (2, 2, np.eye(3)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pc, pf = init_params(cfg, device="cpu")
    assert pc["trunk_0_w"].device.type == "cpu"


def test_pe_mode_routing(monkeypatch):
    """pallas_pe_mode picks the route: None / 'kernel_t' K1/K2's, 'kernel' K3/K4's,
    'outside' K7's then K5/K6's, whose plain embeddings the CPU query builds once for
    its forward and once for its backward, and no other route's; an unknown mode is
    refused by the config and by resolve_pe_mode."""
    import dataclasses

    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.core.pipeline import make_query_fn

    mr, mrv, D, W, skips, ins = CASES[0]
    jp, pts, dirs = _setup(*CASES[0])
    calls = []
    for mode, route in list(tfm.ROUTES.items()):
        monkeypatch.setitem(tfm.ROUTES, mode, dataclasses.replace(
            route, embeddings=lambda *a, _fn=route.embeddings, _mode=mode:
            calls.append(_mode) or _fn(*a)))
    kw = dict(netdepth=D, netwidth=W, multires=mr, multires_views=mrv, skips=skips, ins_num=ins)
    for mode, want in ((None, "kernel_t"), ("kernel_t", "kernel_t"), ("kernel", "kernel"),
                       ("outside", "outside")):
        calls.clear()
        q = make_query_fn(Config(pallas_pe_mode=mode, **kw))
        pp = {k: v.requires_grad_(True) for k, v in _torch(jp).items()}
        q(pp, torch.from_numpy(pts), torch.from_numpy(dirs)).sum().backward()
        assert calls == [want, want], (mode, calls)
    assert [(r.fwd, r.bwd, r.rows) for r in tfm.ROUTES.values()] == [
        ("fused_mlp_fwd", "fused_mlp_bwd", "ray_table"),
        ("fused_mlp_fwd_kpe", "fused_mlp_bwd_kpe", "point_dirs"),
        ("fused_mlp_fwd_pe", "fused_mlp_bwd_pe", "embedded")]
    assert [r.launches for r in tfm.ROUTES.values()] == [
        ("fused_mlp_fwd",), ("fused_mlp_fwd_kpe",), ("fused_pe", "fused_mlp_fwd_pe")]
    with pytest.raises(ValueError, match="pallas_pe_mode"):
        Config(pallas_pe_mode="kernel_tt")
    with pytest.raises(ValueError, match="pallas_pe_mode"):
        tfm.resolve_pe_mode("inside")
    assert make_query_fn(Config(pallas_pe_mode="outside", use_pallas=False, **kw)) is not None


# ---- pe_mode 'outside': K7's plain version against make_pe_pallas (interpret mode) ----

@pytest.mark.parametrize("case", CASES)
def test_pe_points_plain_matches_pallas(case):
    """K7's plain version vs make_pe_pallas in fp32 (interpret mode) at 2e-5 on the
    reference's 3 (1 + 2 multires) columns; the pad columns are exact zeros, and the
    wrapper takes the plain version for a CPU tensor. Points up to 9.5 from the origin
    (ScanNet's far plane), where the top octave's phase is thousands of radians."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    x = (pts.reshape(-1, 3) * 3.0).astype(np.float32)
    want = np.asarray(jfm.make_pe_pallas(mr, jnp.float32, tile=16, interpret=True)(jnp.asarray(x)))
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    got = tfm.pe_points_ref(packed, torch.from_numpy(x))
    n = 3 * (1 + 2 * mr)
    assert got.shape == (x.shape[0], packed.ep) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, :n].numpy(), want, **TOL)
    assert not got[:, n:].any()
    runtime.reset_launches()
    assert torch.equal(tfm.pe_points(packed, torch.from_numpy(x)), got)
    assert not any(runtime.LAUNCHES.values())
    b16 = tfm.pe_points_ref(packed, torch.from_numpy(x), torch.bfloat16)
    assert b16.dtype == torch.bfloat16 and torch.equal(b16, got.to(torch.bfloat16))


def test_pe_backward_plan_reads_the_embeddings_in_place():
    """K6's host table: no embedding in the stash, the dW jobs of the first trunk layer
    and of each skip layer read e from the input (segment source 2), the head's reads
    ed per point (source 1); K2's and K4's tables stash both embeddings and read them
    there."""
    p = tmlp.init_dm_nerf(ins_num=8, D=4, W=32, input_ch_pts=3 * 9, input_ch_views=3 * 5,
                          skips=(1,), device="cpu")
    packed = tfm.pack_params(p, 4, 2, 4, (1,))
    P = 300
    plans = {rows: tfm._bwd_plan(packed, P, 1, 132, rows)
             for rows in ("ray_table", "point_dirs", "embedded")}
    ep, edp = packed.ep, packed.edp
    assert plans["embedded"]["stash_size"] == plans["ray_table"]["stash_size"] - P * (ep + edp)
    assert plans["point_dirs"]["stash_size"] == plans["ray_table"]["stash_size"]

    def segs(rows):
        plan = plans[rows]
        return [[plan["dmaps"][job[0]] for job in plan["jobs"] if job[5] == layer.w_off]
                for layer in packed.layers]
    emb = segs("embedded")
    assert emb[0] == [(2, 0, ep)]                  # emb0: e
    assert emb[2][1] == (2, 0, ep)                 # the layer after skip 1: [h | e]
    assert emb[-2][0] == (1, 0, edp)               # head: ed per point
    assert segs("ray_table")[0] == [(0, 0, ep)]    # K2: e from the stash
    assert segs("ray_table")[-2][0] == (0, plans["ray_table"]["ed_off"], edp)   # and ed
    with pytest.raises(ValueError, match="rows"):
        tfm._bwd_plan(packed, P // 3, 3, 132, "embedded")


def _interpret_bwd_plan(packed, plan, e, ed, g):
    """A plain fp32 reading of ``_bwd_plan``'s tables as the kernels read them: the
    training forward fills the stash at the plan's offsets (unwritten elements stay
    NaN, so a table that points at them shows), the backward-data steps run their
    weight chunks box by box (64 output columns x 256 input rows, A fragments of 16
    columns) and mask by the stash, and each dW job multiplies its segment map by its
    cotangent map. Returns (dw, db) in the Packed layout."""
    P = plan["header"][0]
    c4, no, hr, total_b, total_w, b_out, b_sigma, dpre_out, dpre_sigma = plan["header"][1:10]
    w_all = packed.w.detach()
    stash = torch.full((plan["stash_size"],), float("nan"))

    def put(buf, off, t):
        buf[off:off + t.numel()] = t.reshape(-1)
    if plan["e_off"] >= 0:
        put(stash, plan["e_off"], e)
    if plan["ed_off"] >= 0:
        put(stash, plan["ed_off"], ed)
    h = None
    for layer, off in zip(packed.layers, plan["layer_off"]):
        if layer.kind in ("sigma", "out"):
            assert off == -1
            continue
        a = {"emb0": e, "plain": h, "split": torch.cat([h, e], -1) if h is not None else None,
             "head": torch.cat([ed, h], -1) if h is not None else None}[layer.kind]
        h = torch.relu(a @ tfm._block(w_all, layer) + packed.bias(layer))
        put(stash, off, h)

    dpre = torch.full((plan["dpre_size"],), float("nan"))
    db = torch.full((total_b,), float("nan"))
    G = torch.zeros(P, no)
    G[:, :c4] = g
    G[:, 3] = 0.0
    put(dpre, dpre_out, G)
    dsig = torch.zeros(P, 16)
    dsig[:, 0] = g[:, 3]
    put(dpre, dpre_sigma, dsig)
    db[b_out:b_out + no] = G.sum(0)
    db[b_sigma:b_sigma + 16] = dsig.sum(0)
    a_cols = torch.zeros(P, 256)
    a_cols[:, :no] = G
    for s, (N, c0, nc, b_off, mask_off, d_off) in enumerate(plan["steps"]):
        if s == 1:
            a_cols[:, hr:hr + 16] = dsig
        acc = torch.zeros(P, 256)
        for m, k0, a0, n16 in plan["wchunks"][c0:c0 + nc]:
            w_off, cols, rows = plan["wmaps"][m]
            wm = w_all[w_off:w_off + rows * cols].view(rows, cols)
            box = torch.zeros(256, 64)
            part = wm[:256, k0:k0 + 64]
            box[:part.shape[0], :part.shape[1]] = part
            for ks in range(a0, a0 + n16):
                kk = 16 * (ks - a0)
                acc += a_cols[:, 16 * ks:16 * ks + 16] @ box[:, kk:kk + 16].t()
        x = acc[:, :N] * (stash[mask_off:mask_off + P * N].view(P, N) > 0)
        put(dpre, d_off, x)
        db[b_off:b_off + N] = x.sum(0)
        a_cols = torch.zeros(P, 256)
        a_cols[:, :N] = x

    srcs = {0: stash, 1: ed.reshape(-1), 2: e.reshape(-1), 3: dpre}
    dw = torch.zeros(total_w)
    for amap, bmap, width, N, k_off, w_off in plan["jobs"]:
        src, off, wd = plan["dmaps"][amap]
        bsrc, boff, bw = plan["dmaps"][bmap]
        assert wd == width and bsrc == 3 and bw == N
        A = srcs[src][off:off + P * width].view(P, width)
        B = dpre[boff:boff + P * N].view(P, N)
        dw[w_off + k_off * N:w_off + (k_off + width) * N] = (A.t() @ B).reshape(-1)
    return dw, db


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_bwd_plan_tables_interpret_to_the_plain_backward(case, mode):
    """The tables the backward kernels read (csrc/fused_mlp_bwd.cuh, and the stash the
    training forward writes), read by a plain interpreter over the route's plain
    embeddings, give the plain backward's (dw, db) at 2e-5, for each kernel pair's Rows
    (K2 per-ray viewdirs, K4 per-point directions, K6 over given embeddings); and they
    meet TMA's constraints: 128-byte segment offsets and 16-byte row pitches."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case, N=7, S=9)
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    N, S, _ = pts.shape
    pts_t, dirs_t = torch.from_numpy(pts), torch.from_numpy(dirs)
    g = torch.from_numpy(np.random.RandomState(1).randn(N * S, packed.c4).astype(np.float32))
    e, ed = tfm.ROUTES[mode].embeddings(packed, pts_t, dirs_t, torch.float32)
    want = tfm.query_bwd(packed, pts_t, dirs_t, g.reshape(N, S, -1), mode)
    plan = tfm._query_plan(mode, packed, N, S, 132)
    dw, db = _interpret_bwd_plan(packed, plan, e, ed, g)
    torch.testing.assert_close(dw, want[0], atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(db, want[1], atol=2e-5, rtol=2e-5)

    offsets = [plan["e_off"], plan["ed_off"], *plan["layer_off"], *plan["dpre_off"]]
    offsets += [r[4] for r in plan["steps"]] + [r[5] for r in plan["steps"]]
    offsets += [r[1] for r in plan["dmaps"]] + [r[0] for r in plan["wmaps"]]
    assert all(o == -1 or o % 64 == 0 for o in offsets), offsets
    assert all(2 * r[2] % 16 == 0 for r in plan["dmaps"])
    assert all(2 * r[1] % 16 == 0 and r[2] <= 256 for r in plan["wmaps"])
    assert all(0 < r[3] <= 4 and r[1] % 64 == 0 and r[2] + r[3] <= 16 for r in plan["wchunks"])
    rows_flat = [v for key in ("wmaps", "steps", "wchunks", "dmaps", "jobs", "ranges")
                 for r in plan[key] for v in r]
    assert plan["table"] == plan["header"] + rows_flat
    assert plan["header"][12:] == [len(plan[k]) for k in ("wmaps", "steps", "wchunks", "dmaps",
                                                          "jobs", "ranges")]


def _interpret_fwd_plan(packed, wt, e, ed):
    """A plain fp32 reading of ``_fwd_plan``'s tables as csrc/fused_mlp_fwd.cuh reads
    them: per layer, its chunks in order, each a box of [rows of N, 64 columns of K] of
    the transposed weights ``wt`` (zeros outside the map) times the matching 64
    columns of its A segment (the embeddings padded to 64 columns, h to 256), then the
    layer's epilogue. Returns raw [P, 4+C]."""
    plan = tfm._fwd_plan(packed)
    P = e.shape[0]
    pad = lambda t, n: torch.nn.functional.pad(t, (0, n - t.shape[1]))  # noqa: E731
    tiles = {"e_first": pad(e, 64), "e_last": pad(e, 64), "ed": pad(ed, 64)}
    h = torch.zeros(P, 256)
    chunks = iter(plan["chunks"])
    sigma = None
    for segs, N, b_off, epi in plan["layers"]:
        acc = torch.zeros(P, 256)
        for src in ("ed", "e_first", "h", "e_last"):
            if not segs & tfm._SEG[src]:
                continue
            a_full = h if src == "h" else tiles[src]
            for _ in range(4 if src == "h" else 1):
                m, k0 = next(chunks)
                off, cols, rows, pitch = plan["maps"][m]
                box = torch.zeros(256, 64)
                for r in range(rows):
                    n = max(0, min(64, cols - k0))
                    box[r, :n] = wt[off + r * pitch + k0: off + r * pitch + k0 + n]
                acc += a_full[:, k0:k0 + 64] @ box.t()
        b = torch.zeros(256)
        b[:N] = packed.b[b_off:b_off + N]
        if epi == 0:
            h = torch.relu(acc + b)
            h[:, N:] = 0
        elif epi == 1:
            sigma = acc[:, 0] + b[0]
        else:
            raw = (acc + b)[:, :packed.c4]
            raw[:, 3] = sigma
    assert next(chunks, None) is None
    return raw


@pytest.mark.parametrize("stub", ["full", "sigma", "rgb"])
@pytest.mark.parametrize("case", CASES + [(10, 4, 8, 256, (4,), 6)])
def test_fwd_plan_tables_interpret_to_the_plain_forward(case, stub):
    """The forward kernels' transposed weights are each packed block transposed, bit
    for bit in bf16; and the TMA maps and chunk list of ``_fwd_plan``, read by a plain
    interpreter over the fp32 transposes, give the fp32 plain forward at 2e-5, for the
    full model and both stubs (their 16- and 144-column heads and 16-column outputs).
    The maps meet TMA's constraints: 16-byte aligned starts and row pitches, at most 256
    rows."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case, N=5, S=7)
    params = _torch(jp)
    params = {"full": params, "sigma": tmlp.sigma_stub_params(params),
              "rgb": tmlp.rgb_stub_params(params)}[stub]
    packed = tfm.pack_params(params, mr, mrv, D, skips)
    wt = torch.zeros_like(packed.w)
    for layer in packed.layers:
        blk = packed.w[layer.w_off:layer.w_off + layer.K * layer.N].view(layer.K, layer.N)
        wt[layer.w_off:layer.w_off + layer.K * layer.N] = blk.t().reshape(-1)
        assert torch.equal(packed.wt_bf16[layer.w_off:layer.w_off + layer.K * layer.N],
                           packed.w_bf16[layer.w_off:layer.w_off + layer.K * layer.N]
                           .view(layer.K, layer.N).t().reshape(-1))
    e = tfm.pe_points_ref(packed, torch.from_numpy(pts).reshape(-1, 3))
    ed = tfm.point_view_embedding(packed, torch.from_numpy(dirs), pts.shape[1])
    got = _interpret_fwd_plan(packed, wt, e, ed)
    torch.testing.assert_close(got, tfm._walk_fwd(packed, e, ed, torch.float32), atol=2e-5,
                               rtol=2e-5)
    plan = tfm._fwd_plan(packed)
    assert all(off % 8 == 0 and pitch % 8 == 0 and 0 < rows <= 256
               for off, _, rows, pitch in plan["maps"])
    assert plan["table"][:3] == [len(packed.layers), len(plan["maps"]), len(plan["chunks"])]


# ---- K7's host plan (csrc/fused_pe.cu), read by a plain interpreter ----

# point counts around K7's 128-point tiles and its persistent grid; the last leaves every
# block of a 132-SM card at up to 8 blocks an SM three tiles or more, and a ragged last one
PE_POINTS = [1, 3, 127, 128, 129, 4095, 33869, 132 * 8 * 128 * 3 + 77]
PE_GUARD = 64


def _interpret_pe_plan(plan, rows, P, width):
    """A plain reading of ``_pe_plan`` as csrc/fused_pe.cu walks it with the numbers it
    is launched with: block b takes tiles b, b + grid, ... < tiles, into its staging
    tiles in turn (``copy_bytes`` apart in ``staging_bytes``); thread t of tile i stages
    row i * tile + t (rows < P) at row t of the staging tile; then one bulk copy sends
    the staging tile's first ``copy_bytes`` (``last_copy_bytes`` for the last tile) to
    byte i * copy_bytes of e. A copy reads its staging tile only once the block's next
    tile is staged (one copy in flight), so too few staging tiles show as wrong rows.
    ``rows`` [P, width] bf16 holds each point's row. Returns e with PE_GUARD rows after
    row P (NaN where nothing was written) and the count of writes of each element."""
    tile, tiles, grid = plan["tile"], plan["tiles"], plan["grid"]
    copy_b, last_b, staging_b = plan["copy_bytes"], plan["last_copy_bytes"], plan["staging_bytes"]
    walks = [list(range(b, tiles, grid)) for b in range(grid)]
    assert sorted(i for w in walks for i in w) == list(range(tiles))
    assert {len(w) for w in walks} <= {plan["tiles_per_block"], plan["tiles_per_block"] - 1}
    assert all(n % 16 == 0 and n > 0 for n in (copy_b, last_b, staging_b))
    assert last_b // (width * 2) == plan["last_rows"]
    e = torch.full(((P + PE_GUARD) * width,), float("nan"), dtype=torch.bfloat16)
    writes = torch.zeros_like(e, dtype=torch.int32)
    for walk in walks:
        staging = torch.full((staging_b // 2,), float("nan"), dtype=torch.bfloat16)
        pending = []      # the copy in flight, read once the next tile is staged
        for k, i in enumerate(walk + [None]):
            if i is not None:
                base = (k % (staging_b // copy_b)) * copy_b // 2
                r = min(tile, P - i * tile)          # thread t's row at t * width
                assert r * width <= copy_b // 2
                staging[base:base + r * width] = rows[i * tile:i * tile + r].reshape(-1)
            for j, src in pending:
                n = (last_b if j == tiles - 1 else copy_b) // 2
                assert src + n <= staging_b // 2
                e[j * copy_b // 2:j * copy_b // 2 + n] = staging[src:src + n]
                writes[j * copy_b // 2:j * copy_b // 2 + n] += 1
            pending = [] if i is None else [(i, base)]
    return e.view(P + PE_GUARD, width), writes.view(P + PE_GUARD, width)


@pytest.mark.parametrize("P", PE_POINTS)
@pytest.mark.parametrize("multires", [4, 6, 10])
def test_pe_plan_interprets_to_the_plain_embedding(multires, P):
    """K7's host plan for a 132-SM card at 6 blocks an SM and for a 2-SM one at 1 block
    (hundreds of tiles a block), read by a plain interpreter of the kernel's walk
    (persistent grid, two staging tiles, one bulk copy a tile) with the numbers the
    kernel is launched with, at the packed widths of multires 4, 6 and 10 (EP 32, 48,
    64): every element of e [P, EP] is written exactly once, with pe_points_ref's bf16
    row, and nothing past row P; each copy is a multiple of 16 bytes at a 16-byte
    offset; the grid is as small as the tiles a block allow."""
    p = tmlp.init_dm_nerf(ins_num=4, D=2, W=32, input_ch_pts=3 * (1 + 2 * multires),
                          input_ch_views=3 * 5, skips=(0,), device="cpu")
    packed = tfm.pack_params(p, multires, 2, 2, (0,))
    x = torch.from_numpy(np.random.RandomState(P).uniform(-9.5, 9.5, (P, 3)).astype(np.float32))
    want = tfm.pe_points_ref(packed, x, torch.bfloat16)
    for n_sms, per_sm in ((132, 6), (2, 1)):
        plan = tfm._pe_plan(P, packed.ep, n_sms, per_sm)
        assert plan["grid"] <= n_sms * per_sm
        assert plan["grid"] == -(-plan["tiles"] // plan["tiles_per_block"])
        e, writes = _interpret_pe_plan(plan, want, P, packed.ep)
        assert torch.equal(writes[:P], torch.ones_like(writes[:P])) and not writes[P:].any()
        assert torch.equal(e[:P].view(torch.int16), want.view(torch.int16))
        assert torch.isnan(e[P:].float()).all()


# what each variant of scripts/bwd_data_ablation_torch.py leaves out of bwd_data_kernel:
# text of csrc/fused_mlp_bwd.cuh that the variant must no longer hold
ABLATED = {"no_store": ["tma_store_2d(&p.dpre_maps"],
           "no_mask": ["tma_load_2d(mtile", "ldmatrix_x4(", "relu_mask(m"],
           "no_shuffle": ["__shfl_xor_sync(0xffffffffu, send"]}
ABLATED["bare"] = sum(ABLATED.values(), [])


@pytest.mark.parametrize("variant", sorted(ABLATED))
def test_bwd_data_ablation_cuts_the_kernel_source(variant):
    """The ablation script builds its variants by cutting named text out of the backward
    kernel's source, and raises where the source no longer holds it: on this source each
    variant leaves out what it names, and keeps the rest of the kernel."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "bwd_data_ablation_torch.py")
    spec = importlib.util.spec_from_file_location("bwd_data_ablation_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (runtime.CSRC / "fused_mlp_bwd.cuh").read_text()
    got = mod.variants(src)
    assert got["full"] == src and set(got) == {"full", *ABLATED}
    for text in ABLATED[variant]:
        assert text in src and text not in got[variant], text
    assert "wgmma_rs_n256(" in got[variant] and "stmatrix_x4(" in got[variant]
    with pytest.raises(RuntimeError, match="no longer holds"):
        mod.variants(src.replace("tma_store_2d(&p.dpre_maps", "tma_store_2d(&p.other_maps"))
