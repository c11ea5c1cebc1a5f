"""dmnerf_tpu_torch core vs dmnerf_tpu core on the CPU: configs, positional
encoding, rays, the MLP and its stubs, samplers, compositor and render_rays.

Inputs are made with numpy from a seed, JAX parameters are carried across with
params_from_numpy, and JAX random draws are handed to the port as uniforms. The bar
is the JAX package's fp32 one, atol/rtol 2e-5 (tests/test_kernels.py), under the
'highest' matmul precision tests/conftest.py pins; render_rays is held at 1e-4
because a round-off difference can move a sample_pdf rank.
"""

import dataclasses
import glob
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu import configs as jcfg  # noqa: E402
from dmnerf_tpu.core import compositor as jcomp  # noqa: E402
from dmnerf_tpu.core import embedding as jemb  # noqa: E402
from dmnerf_tpu.core import mlp as jmlp  # noqa: E402
from dmnerf_tpu.core import pipeline as jpipe  # noqa: E402
from dmnerf_tpu.core import rays as jrays  # noqa: E402
from dmnerf_tpu.core import sampling as jsamp  # noqa: E402
from dmnerf_tpu_torch import configs as tcfg  # noqa: E402
from dmnerf_tpu_torch.core import compositor as tcomp  # noqa: E402
from dmnerf_tpu_torch.core import embedding as temb  # noqa: E402
from dmnerf_tpu_torch.core import mlp as tmlp  # noqa: E402
from dmnerf_tpu_torch.core import pipeline as tpipe  # noqa: E402
from dmnerf_tpu_torch.core import rays as trays  # noqa: E402
from dmnerf_tpu_torch.core import sampling as tsamp  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), **(tol or TOL))


def _jax_params(seed, ins_num=4, D=3, W=32, mr=4, mrv=2, skips=(1,)):
    p = jmlp.init_dm_nerf(jax.random.PRNGKey(seed), ins_num=ins_num, D=D, W=W,
                          input_ch_pts=3 * (1 + 2 * mr), input_ch_views=3 * (1 + 2 * mrv),
                          skips=skips)
    return p, tmlp.params_from_numpy({k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.mark.parametrize("tree", ["train", "test", "manipulation"])
def test_config_files_parse_the_same(tree):
    files = sorted(glob.glob(os.path.join(REPO, "configs", tree, "**", "*.txt"), recursive=True))
    assert files
    for path in files:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = dataclasses.asdict(jcfg.load_config(path))
            got = dataclasses.asdict(tcfg.load_config(path))
        assert got == want, path


def test_config_aliases_cli_and_errors():
    text = "over_penalize\ntolerance = 0.05\ndeta_w = 0.05\neditor_val\neditor_mode = scale\nskips = 2, 5"
    assert dataclasses.asdict(tcfg.parse_config_text(text)) == \
        dataclasses.asdict(jcfg.parse_config_text(text))
    with pytest.warns(UserWarning, match="did you mean 'N_iters'"):
        tcfg.parse_config_text("n_iters = 3")
    with pytest.raises(ValueError, match="tolerance"):
        tcfg.parse_config_text("penalize")
    cfg = tcfg.parse_cli(["--config", os.path.join(REPO, "configs/test/dmsr/study.txt"),
                          "netwidth=64", "--mesh"])
    assert (cfg.netwidth, cfg.mesh, cfg.far, cfg.render) == (64, True, 15.0, True)


@pytest.mark.parametrize("multires", [0, 4, 10])
def test_positional_encoding(multires):
    x = np.random.RandomState(0).uniform(-4, 4, (5, 7, 3)).astype(np.float32)
    assert temb.embed_dim(multires) == jemb.embed_dim(multires)
    _close(temb.positional_encoding(_t(x), multires), jemb.positional_encoding(jnp.asarray(x), multires))


def test_rays():
    rng = np.random.RandomState(1)
    K = np.array([[20.0, 0, 8.0], [0, -20.0, 6.0], [0, 0, -1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    c2w[:3, 3] = rng.randn(3)
    for got, want in zip(trays.rays_from_K(12, 16, _t(K), _t(c2w)),
                         jrays.rays_from_K(12, 16, jnp.asarray(K), jnp.asarray(c2w))):
        _close(got, want)
    py, px = rng.randint(0, 12, 9), rng.randint(0, 16, 9)
    for got, want in zip(trays.rays_for_pixels(torch.from_numpy(py), torch.from_numpy(px), _t(K), _t(c2w)),
                         jrays.rays_for_pixels(jnp.asarray(py), jnp.asarray(px), jnp.asarray(K),
                                               jnp.asarray(c2w))):
        _close(got, want)
    for got, want in zip(trays.rays_from_focal(6, 5, 7.5, _t(c2w)),
                         jrays.rays_from_focal(6, 5, 7.5, jnp.asarray(c2w))):
        _close(got, want)


@pytest.mark.parametrize("stub", [None, "sigma", "rgb"])
def test_dm_nerf_apply_and_stubs(stub):
    jp, tp = _jax_params(2, D=4, skips=(1, 2))
    rng = np.random.RandomState(2)
    e = rng.randn(6, 5, 27).astype(np.float32)
    ed = rng.randn(6, 5, 15).astype(np.float32)
    if stub is not None:
        jp = getattr(jmlp, f"{stub}_stub_params")(jp)
        tp = getattr(tmlp, f"{stub}_stub_params")(tp)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    want = jmlp.dm_nerf_apply(jp, jnp.asarray(e), jnp.asarray(ed), D=4, skips=(1, 2))
    _close(tmlp.dm_nerf_apply(tp, _t(e), _t(ed), D=4, skips=(1, 2)), want)


def test_init_is_seeded_and_ins_gradient_wall():
    kw = dict(ins_num=4, D=3, W=16, input_ch_pts=27, input_ch_views=15, skips=(1,), device="cpu")
    a = tmlp.init_dm_nerf(generator=torch.Generator().manual_seed(5), **kw)
    b = tmlp.init_dm_nerf(generator=torch.Generator().manual_seed(5), **kw)
    jp = jmlp.init_dm_nerf(jax.random.PRNGKey(0), 4, 3, 16, 27, 15, (1,))
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: v.shape for k, v in jp.items()}
    for k in a:
        assert torch.equal(a[k], b[k])
        bound = 1.0 / np.sqrt(a[k].shape[0] if k.endswith("_w") else jp[k.replace("_b", "_w")].shape[0])
        assert float(a[k].abs().max()) <= bound
    # an instance-only loss sends nothing into the trunk (the reference's h.detach())
    params = {k: v.clone().requires_grad_(True) for k, v in a.items()}
    rng = np.random.RandomState(3)
    raw = tmlp.dm_nerf_apply(params, _t(rng.randn(8, 27)), _t(rng.randn(8, 15)), D=3, skips=(1,))
    raw[..., 4:].sum().backward()
    for k, v in params.items():
        if k.startswith(("trunk_", "rgb_", "density")):
            assert v.grad is None or float(v.grad.abs().max()) == 0.0, k
    assert float(params["ins_out_w"].grad.abs().sum()) > 0.0


def test_sample_pdf_det_and_injected_uniforms():
    rng = np.random.RandomState(4)
    bins = np.sort(rng.uniform(2, 6, (7, 9)).astype(np.float32), axis=-1)
    w = rng.rand(7, 8).astype(np.float32)
    w[0] = 0.0                      # an all-zero row: every denominator is guarded
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 11, key=None)
    _close(tsamp.sample_pdf(_t(bins), _t(w), 11), want)
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, (7, 11), dtype=jnp.float32)
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 11, key=key)
    _close(tsamp.sample_pdf(_t(bins), _t(w), 11, u=_t(u)), want)
    z = np.asarray(jsamp.z_val_sample(7, 2.0, 6.0, 9))
    _close(tsamp.z_val_sample(7, 2.0, 6.0, 9), z)
    uz = jax.random.uniform(key, z.shape, dtype=jnp.float32)
    _close(tsamp.perturb_z_vals(_t(z), u=_t(uz)), jsamp.perturb_z_vals(key, jnp.asarray(z)))


@pytest.mark.parametrize("use_log_scan", [True, False])
def test_composite_and_composite_maps(use_log_scan):
    rng = np.random.RandomState(5)
    raw = (rng.randn(6, 10, 4 + 5) * 2).astype(np.float32)
    raw[0, 3:, 3] = 1e4             # saturated alpha: the clamped log-scan branch
    z = np.sort(rng.uniform(1, 8, (6, 10)).astype(np.float32), axis=-1)
    d = rng.randn(6, 3).astype(np.float32)
    for keep_air, detach in ((False, True), (True, False)):
        want = jcomp.composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), keep_air=keep_air,
                               detach_ins_weights=detach, use_log_scan=use_log_scan)
        got = tcomp.composite(_t(raw), _t(z), _t(d), keep_air=keep_air, detach_ins_weights=detach,
                              use_log_scan=use_log_scan)
        for g, w_ in zip(got, want):
            _close(g, w_)
    for keep_air in (False, True):
        want = jcomp.composite_maps(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), keep_air)
        got = tcomp.composite_maps(_t(raw), _t(z), _t(d), keep_air)
        for g, w_ in zip(got, want):
            _close(g, w_)


@pytest.mark.parametrize("perturb", [False, True])
def test_render_rays(perturb):
    mr, mrv, D, skips = 4, 2, 3, (1,)
    jpc, tpc = _jax_params(8, D=D, skips=skips)
    jpf, tpf = _jax_params(9, D=D, skips=skips)
    rng = np.random.RandomState(6)
    N, S, NI = 5, 8, 6
    o = rng.randn(N, 3).astype(np.float32) * 0.1
    d = rng.randn(N, 3).astype(np.float32)
    z = np.asarray(jsamp.z_val_sample(N, 2.0, 6.0, S))
    key = jax.random.PRNGKey(3) if perturb else None
    want = jpipe.render_rays(jpc, jpf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                             jpipe.make_xla_query_fn(mr, mrv, D, skips), N_importance=NI,
                             perturb=perturb, key=key)
    kw = {}
    if perturb:
        kz, kp = jax.random.split(key)
        kw = dict(u_z=_t(jax.random.uniform(kz, (N, S))), u_pdf=_t(jax.random.uniform(kp, (N, NI))))
    got = tpipe.render_rays(tpc, tpf, _t(o), _t(d), _t(z), tpipe.make_torch_query_fn(mr, mrv, D, skips),
                            N_importance=NI, perturb=perturb, **kw)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-4, rtol=1e-4)
