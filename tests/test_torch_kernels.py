"""dmnerf_tpu_torch.kernels.fused_mlp on the CPU: packing vs the JAX _pack, the
kernel's fp32 plain version vs the Pallas kernel (interpret mode, pe_mode
'kernel_t') and the XLA query at 2e-5 on the CASES of tests/test_kernels.py, the
sigma stub's exact sigma column, and the guards: no JAX import, no fallback, no
gradients, no silent CPU.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py."""

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
from dmnerf_tpu_torch.kernels import fused_mlp as tfm  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
CASES = [
    # (multires, multires_views, D, W, skips, ins_num), as tests/test_kernels.py
    (4, 2, 2, 32, (0,), 4),
    (10, 4, 8, 64, (4,), 8),
    (6, 3, 5, 32, (1, 3), 4),
]


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


@pytest.mark.parametrize("case", CASES)
def test_plain_fp32_matches_pallas_and_xla(case):
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    q_pal = jfm.make_pallas_query_fn(mr, mrv, D, skips, tile_fwd=16, tile_bwd=16,
                                     interpret=True, pe_mode="kernel_t")
    q_xla = make_xla_query_fn(mr, mrv, D, skips)
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    got = tfm.fused_query_ref(packed, torch.from_numpy(pts), torch.from_numpy(dirs)).numpy()
    for q in (q_pal, q_xla):
        want = np.asarray(q(jp, jnp.asarray(pts), jnp.asarray(dirs)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_stub_columns_exact(case):
    """The sigma stub's sigma column, and the rgb stub's sigma and instance columns,
    are bit-equal to the full model's."""
    mr, mrv, D, W, skips, ins = case
    jp, pts, dirs = _setup(*case)
    args = (mr, mrv, D, skips)
    pts_t, dirs_t = torch.from_numpy(pts), torch.from_numpy(dirs)
    full = tfm.fused_query(tfm.pack_params(_torch(jp), *args), pts_t, dirs_t)
    sig = tfm.fused_query(tfm.pack_params(_torch(sigma_stub_params(jp)), *args), pts_t, dirs_t)
    rgb = tfm.fused_query(tfm.pack_params(_torch(rgb_stub_params(jp)), *args), pts_t, dirs_t)
    assert sig.shape[-1] == 5 and rgb.shape == full.shape
    assert torch.equal(sig[..., 3], full[..., 3])
    assert torch.equal(rgb[..., 3:], full[..., 3:])


def test_bf16_plain_rounds_like_the_kernel():
    """act_dtype=bfloat16 rounds embeddings, weights and activations to bf16: close to
    fp32 at bf16 scale, and exactly the fp32 path when the inputs are bf16-exact."""
    mr, mrv, D, W, skips, ins = CASES[1]
    jp, pts, dirs = _setup(*CASES[1], N=8, S=16)
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    p, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    f32 = tfm.fused_query_ref(packed, p, d, torch.float32)
    b16 = tfm.fused_query_ref(packed, p, d, torch.bfloat16)
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


def test_import_guard():
    """No module of the port, nor chip_smoke.py, imports JAX or the JAX package."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import dmnerf_tpu_torch\n"
        "for m in pkgutil.walk_packages(dmnerf_tpu_torch.__path__, 'dmnerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'dmnerf_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('dmnerf_tpu_torch')]))\n"
    )
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cpu_wrapper_takes_the_plain_version():
    mr, mrv, D, W, skips, ins = CASES[0]
    jp, pts, dirs = _setup(*CASES[0])
    packed = tfm.pack_params(_torch(jp), mr, mrv, D, skips)
    runtime.reset_launches()
    got = tfm.fused_query(packed, torch.from_numpy(pts), torch.from_numpy(dirs))
    want = tfm.fused_query_ref(packed, torch.from_numpy(pts), torch.from_numpy(dirs))
    assert torch.equal(got, want)
    assert runtime.LAUNCHES == {"fused_mlp_fwd": 0}


def test_wrapper_refuses_parameters_that_require_grad():
    mr, mrv, D, W, skips, ins = CASES[0]
    jp, pts, dirs = _setup(*CASES[0])
    params = {k: v.requires_grad_(True) for k, v in _torch(jp).items()}
    packed = tfm.pack_params(params, mr, mrv, D, skips)
    with pytest.raises(ValueError, match="forward-only"):
        tfm.fused_query(packed, torch.from_numpy(pts), torch.from_numpy(dirs))


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
