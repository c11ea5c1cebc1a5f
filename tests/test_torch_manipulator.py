"""The port's manipulation slice (dmnerf_tpu_torch.render.manipulator, render.mani_eval,
tools.pose_gen, data.dmsr_mani, the manipulated-GT scene writer and test.py's
mani_eval / mani_demo modes) against the JAX package on the CPU, at a small size
(D = 4, W = 64, ins_num 8). The port's query is the fused path under
pallas_pe_mode = 'kernel' (K3's plain version on the CPU); the JAX side runs its own
config-driven query.

Tolerances: exchange is exact; manipulate_rays and the chunked renderer at 1e-4 (as
the render slice: a round-off difference can move a sample_pdf rank). The argmax
labels that key the exchange are taken where the top-2 instance logits are apart by
more than 1e-4 (checked: a near-tie would flip a whole sample's raw between bundles);
the seeds below clear it."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.core.mlp import init_dm_nerf  # noqa: E402
from dmnerf_tpu.render import manipulator as jman  # noqa: E402
from dmnerf_tpu.tools import pose_gen as jpose  # noqa: E402
from dmnerf_tpu_torch.configs import Config as TConfig  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.render import manipulator as tman  # noqa: E402
from dmnerf_tpu_torch.tools import pose_gen as tpose  # noqa: E402

torch.set_num_threads(2)
RTOL = dict(atol=1e-4, rtol=1e-4)
INS = 8
KW = dict(netdepth=4, netwidth=64, skips=(2,), multires=10, multires_views=4, ins_num=INS,
          N_samples=9, N_importance=8, near=2.0, far=6.0)


def _params(seed):
    jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=INS, D=KW["netdepth"],
                      W=KW["netwidth"], skips=KW["skips"])
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _bundles(seed, n, K):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 0.1
    d = rng.randn(n, 3).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    tar = [(o + np.array([0.3 * (k + 1), -0.1 * k, 0.0], np.float32), d.copy()) for k in range(K)]
    return (o, d), tar


def _jax_args(ori, tar):
    return (jnp.asarray(ori[0]), jnp.asarray(ori[1])), [(jnp.asarray(o), jnp.asarray(d)) for o, d in tar]


def _torch_args(ori, tar):
    return (torch.from_numpy(ori[0]), torch.from_numpy(ori[1])), \
        [(torch.from_numpy(o), torch.from_numpy(d)) for o, d in tar]


def test_exchange_matches_jax():
    """Identical raws and accumulated maps through both exchanges, one and two moved
    labels: the exchanged raw and both label maps are identical."""
    rng = np.random.RandomState(4)
    N, S, C = 16, 12, 4 + INS + 1
    ori_raw = rng.randn(N, S, C).astype(np.float32)
    tar_raws = [rng.randn(N, S, C).astype(np.float32) for _ in range(2)]
    ori_accum = (1 / (1 + np.exp(-rng.randn(N, INS + 1)))).astype(np.float32)
    tar_accums = [(1 / (1 + np.exp(-rng.randn(N, INS + 1)))).astype(np.float32) for _ in range(2)]
    for labels in ([2], [2, 4]):
        k = len(labels)
        want = jman.exchange(jnp.asarray(ori_raw), [jnp.asarray(t) for t in tar_raws[:k]],
                             jnp.asarray(ori_accum), [jnp.asarray(t) for t in tar_accums[:k]],
                             labels)
        got = tman.exchange(torch.from_numpy(ori_raw), [torch.from_numpy(t) for t in tar_raws[:k]],
                            torch.from_numpy(ori_accum),
                            [torch.from_numpy(t) for t in tar_accums[:k]], labels)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert len(got[1]) == k


def _label_margin(tp, ori, tar, cfg):
    """The smallest top-2 gap of the instance logits over the bundles' fine queries at
    the coarse z: a guard that the test's argmax labels are no near-ties."""
    from dmnerf_tpu_torch.core.pipeline import make_query_fn
    from dmnerf_tpu_torch.core.sampling import z_val_sample

    q = make_query_fn(cfg)
    margins = []
    for o, d in [ori, *tar]:
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        z = z_val_sample(o.shape[0], cfg.near, cfg.far, cfg.N_samples)
        raw = tman._query_at(q, q.prepare(tp), o, d, z)
        top = torch.topk(raw[..., 4:], 2, dim=-1).values
        margins.append(float((top[..., 0] - top[..., 1]).min()))
    return min(margins)


@pytest.mark.parametrize("mode", ["deterministic", "injected_draws", "rgb_stub_off"])
def test_manipulate_rays_matches_jax(mode):
    """The two-pass union-z edit with K = 2 targets vs the JAX package's at 1e-4:
    deterministic draws (key=None), the JAX package's own draws injected, and with
    rgb_stub off (which must give the port's rgb_stub output bit for bit)."""
    jp, tp = _params(7)
    ori, tar = _bundles(9, 12, 2)
    jcfg, tcfg = JConfig(use_pallas=True, **KW), TConfig(pallas_pe_mode="kernel", **KW)
    assert _label_margin(tp, ori, tar, tcfg) > 1e-4
    key = jax.random.PRNGKey(3) if mode == "injected_draws" else None
    want = jman.manipulate_rays(jcfg, jp, jp, *_jax_args(ori, tar), [2, 5], key=key)
    u = None
    if key is not None:
        keys = jax.random.split(key, 2 * 2 + 2)
        u = [torch.from_numpy(np.array(jax.random.uniform(k, (12, KW["N_importance"]))))
             for k in keys]
    runtime.reset_launches()
    got = tman.manipulate_rays(tcfg, tp, tp, *_torch_args(ori, tar), [2, 5], u=u,
                               rgb_stub=mode != "rgb_stub_off")
    assert not any(runtime.LAUNCHES.values())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **RTOL)
    if mode == "rgb_stub_off":
        stub = tman.manipulate_rays(tcfg, tp, tp, *_torch_args(ori, tar), [2, 5])
        for k in got:
            assert torch.equal(stub[k], got[k]), k


def test_manipulate_rays_generator_draws_are_reproducible():
    """With a generator the draws are random: the same seed gives the same maps, the
    rgb_stub toggle changes nothing, and the maps are finite and in range."""
    _, tp = _params(7)
    ori, tar = _bundles(9, 12, 1)
    tcfg = TConfig(pallas_pe_mode="kernel", **KW)
    outs = [tman.manipulate_rays(tcfg, tp, tp, *_torch_args(ori, tar), [2],
                                 generator=torch.Generator().manual_seed(5), rgb_stub=stub)
            for stub in (True, False, True)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]) and torch.equal(outs[0][k], outs[2][k]), k
    det = tman.manipulate_rays(tcfg, tp, tp, *_torch_args(ori, tar), [2])
    assert not torch.equal(outs[0]["rgb"], det["rgb"])
    for k in ("rgb", "ins"):
        v = outs[0][k]
        assert torch.isfinite(v).all() and float(v.min()) >= 0 and float(v.max()) <= 1


def test_manipulator_renderer_ragged_chunks_matches_jax():
    """50 rays in chunks of 16 (14 rows of zero padding in the last), K = 2,
    deterministic draws, vs the JAX renderer at 1e-4; with a generator the render is
    reproducible and finite."""
    jpc, tpc = _params(1)
    jpf, tpf = _params(2)
    n, K = 50, 2
    ori, tar = _bundles(3, n, K)
    kw = dict(KW, N_test=16)
    jrun = jman.make_manipulator_renderer(JConfig(use_pallas=True, **kw), K)
    trun = tman.make_manipulator_renderer(TConfig(pallas_pe_mode="kernel", **kw), K)
    tar_o = np.stack([o for o, _ in tar])
    tar_d = np.stack([d for _, d in tar])
    want = jrun(jpc, jpf, jnp.asarray(ori[0]), jnp.asarray(ori[1]), jnp.asarray(tar_o),
                jnp.asarray(tar_d), (2, 5))
    targs = (torch.from_numpy(ori[0]), torch.from_numpy(ori[1]), torch.from_numpy(tar_o),
             torch.from_numpy(tar_d), (2, 5))
    got = trun(tpc, tpf, *targs)
    assert set(got) == set(want) == {"rgb", "ins", "tar_rgb"}
    for k in want:
        assert got[k].shape[0] == n
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **RTOL)
    a = trun(tpc, tpf, *targs, generator=torch.Generator().manual_seed(0))
    b = trun(tpc, tpf, *targs, generator=torch.Generator().manual_seed(0))
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all(), k


@pytest.mark.parametrize("func", ["sin", "ex", "linear", "abs_linear", "ln"])
def test_deform_ray_offsets_match_jax(func):
    got = tman.deform_ray_offsets(23, 7, func, 0.18)
    want = jman.deform_ray_offsets(23, 7, func, 0.18)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pose_gen_json_identical(tmp_path):
    """transformation_matrix.json of the four eval modes and of a demo series with
    translation, rotation, scale and deform objects: the same text as the JAX
    package's."""
    def text(d):
        with open(d / "transformation_matrix.json") as f:
            return f.read()

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for mode in ("translation", "rotation", "scale", "multi"):
        for expname in ("study", "no_such_scene"):
            kw = dict(mani_mode=mode, expname=expname)
            tpose.generate_poses_eval(TConfig(datadir=str(tmp_path / "t"), **kw))
            jpose.generate_poses_eval(JConfig(datadir=str(tmp_path / "j"), **kw))
            assert text(tmp_path / "t") == text(tmp_path / "j"), (mode, expname)
    objs = [
        {"obj_name": "a", "mani_mode": "translation", "obj_center": [0.1, -0.2, 0.3],
         "distance": [0.5, -0.25]},
        {"obj_name": "b", "mani_mode": "rotation", "obj_center": [1.0, 0.0, -0.5]},
        {"obj_name": "c", "mani_mode": "scale", "obj_center": [0.0, 0.4, 0.0]},
        {"obj_name": "d", "mani_mode": "deform", "deform_func": "sin"},
    ]
    out = tpose.generate_poses_demo(objs, TConfig(datadir=str(tmp_path / "t"), views=5))
    jpose.generate_poses_demo(objs, JConfig(datadir=str(tmp_path / "j"), views=5))
    assert text(tmp_path / "t") == text(tmp_path / "j")
    assert set(out) == {"a", "b", "c"} and len(out["a"]) == 10 and len(out["b"]) == 5
    assert out == tpose.demo_poses(objs, 5)


def test_load_dmsr_mani_identical(tmp_path):
    """The port's writer + loader, the JAX package's writer + loader and the in-memory
    scene give identical arrays for the manipulated ground truth."""
    from dmnerf_tpu.data.dmsr_mani import load_dmsr_mani as j_load
    from dmnerf_tpu.data.synthetic import write_dmsr_scene as j_write
    from dmnerf_tpu_torch.data.dmsr_mani import load_dmsr_mani
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_mani_scene, write_dmsr_scene

    kw = dict(n_train=2, n_test=4, H=14, W=18, n_objects=3, ins_num=6, seed=2)
    modes = ["translation", "scale"]
    write_dmsr_scene(str(tmp_path / "t"), mani_modes=modes, **kw)
    j_write(str(tmp_path / "j"), mani_modes=modes, **kw)
    with open(tmp_path / "t" / "transforms.json") as f, open(tmp_path / "j" / "transforms.json") as g:
        assert f.read() == g.read()
    for mode in modes:
        for testskip in (1, 3):
            loaded = load_dmsr_mani(TConfig(datadir=str(tmp_path / "t"), mani_mode=mode,
                                            testskip=testskip))
            j_loaded = j_load(JConfig(datadir=str(tmp_path / "j"), mani_mode=mode,
                                      testskip=testskip))
            built = build_dmsr_mani_scene(mode, n_test=kw["n_test"], H=kw["H"], W=kw["W"],
                                          n_objects=kw["n_objects"], ins_num=kw["ins_num"],
                                          seed=kw["seed"], testskip=testskip)
            for field in ("images", "poses", "H", "W", "K", "i_train", "i_test", "gt_labels",
                          "ins_rgbs", "ins_num"):
                for other in (j_loaded, built):
                    a, b = getattr(loaded, field), getattr(other, field)
                    if isinstance(a, np.ndarray):
                        assert a.dtype == b.dtype and np.array_equal(a, b), (mode, field)
                    else:
                        assert a == b, (mode, field)
    moved = load_dmsr_mani(TConfig(datadir=str(tmp_path / "t"), mani_mode="translation"))
    from dmnerf_tpu_torch.data.dmsr import load_dmsr

    orig = load_dmsr(TConfig(datadir=str(tmp_path / "t")))
    assert not np.array_equal(moved.gt_labels, orig.gt_labels[orig.i_test])


# ---- the entry point: test.py mani_eval / mani_demo, the JAX test.py's artifact layout

H = W = 24
N_TEST_VIEWS = 2
DRV = dict(expname="drv", dataset_type="dmsr", N_samples=8, N_importance=8, N_train=64,
           N_test=256, near=1.0, far=8.0, netdepth=2, netwidth=32, multires=4, multires_views=2,
           ins_num=6, testskip=1, views=2)


@pytest.fixture(scope="module")
def mani_env(tmp_path_factory):
    from dmnerf_tpu.render.trainstep import create_train_state
    from dmnerf_tpu.utils.checkpoint import save_checkpoint as j_save
    from dmnerf_tpu_torch.data.synthetic import write_dmsr_scene
    from dmnerf_tpu_torch.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("mani_entry")
    datadir = root / "dmsr" / "study"
    write_dmsr_scene(str(datadir), n_train=2, n_test=N_TEST_VIEWS, H=H, W=W, n_objects=3,
                     ins_num=DRV["ins_num"], mani_modes=["translation"])
    jcfg = JConfig(basedir=str(root / "jax_logs"), datadir=str(datadir), use_pallas=False, **DRV)
    tcfg = TConfig(basedir=str(root / "torch_logs"), datadir=str(datadir),
                   pallas_pe_mode="kernel", **DRV)
    state = create_train_state(jcfg, jax.random.PRNGKey(0))
    j_save(jcfg.log_dir, state)

    def convert(p):
        return params_from_numpy({k: np.asarray(v) for k, v in p.items()}, device="cpu")

    save_checkpoint(tcfg.log_dir, convert(state.params_coarse), convert(state.params_fine), 0)
    return jcfg, tcfg


def _png_shape(path):
    import imageio.v2 as imageio

    return imageio.imread(path).shape


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("mode", ["mani_eval", "mani_demo"])
def test_run_test_mani_artifacts_match_jax_layout(mani_env, mode):
    """test.py mani_eval / mani_demo on device='cpu' (mani_demo through the command
    line, ``--device cpu``) write the files the JAX package's test.py writes: the same
    names under the same save dirs, PNGs of the scene's H x W, a 9-column
    test_results.txt with its mean row, and the same transformation_matrix.json."""
    from dmnerf_tpu.test import run_test as j_run_test
    from dmnerf_tpu_torch.test import main, run_test

    jcfg, tcfg = mani_env
    extra = dict(mani_eval=True, mani_mode="translation", target_label=1) \
        if mode == "mani_eval" else dict(mani_demo=True)
    j_run_test(jcfg.replace(**extra))
    with open(os.path.join(jcfg.datadir, "transformation_matrix.json")) as f:
        want_tm = f.read()
    runtime.reset_launches()
    if mode == "mani_eval":
        run_test(tcfg.replace(**extra), device="cpu")
    else:   # through the command line
        kw = dict(DRV, basedir=tcfg.basedir, datadir=tcfg.datadir, pallas_pe_mode="kernel", **extra)
        main(["--device", "cpu", *(f"{k}={v}" for k, v in kw.items())])
    assert not any(runtime.LAUNCHES.values())
    with open(os.path.join(tcfg.datadir, "transformation_matrix.json")) as f:
        assert f.read() == want_tm
    sub = os.path.join(f"{mode}_000000", "translation" if mode == "mani_eval" else "mani_output")
    jdir, tdir = os.path.join(jcfg.log_dir, sub), os.path.join(tcfg.log_dir, sub)
    assert _files(tdir) == _files(jdir)
    for name in _files(tdir):
        if name.endswith(".png"):
            assert _png_shape(os.path.join(tdir, name))[:2] == (H, W), name
    if mode == "mani_eval":
        table = np.loadtxt(os.path.join(tdir, "test_results.txt"))
        assert table.shape == (N_TEST_VIEWS + 1, 9)
        mask = ~np.isnan(table[-1])
        np.testing.assert_allclose(table[-1][mask], np.nanmean(table[:-1], axis=0)[mask], atol=1e-5)
        with open(os.path.join(tdir, "matching_log.json")) as f:
            assert len(json.load(f)) == N_TEST_VIEWS
    else:
        assert {f"{i}_{s}.png" for i in range(2) for s in ("rgb", "ins", "ins_pred_mask")} \
            <= set(_files(tdir))


def test_mani_entry_points_need_cuda_or_an_explicit_cpu(mani_env, monkeypatch):
    from dmnerf_tpu_torch.render.mani_eval import manipulator_demo, manipulator_eval
    from dmnerf_tpu_torch.test import run_test

    _, tcfg = mani_env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_test(tcfg.replace(mani_demo=True)),
                 lambda: manipulator_eval(tcfg, {}, {}, np.eye(4)[None], (2, 2, np.eye(3)),
                                          [{"transformation": np.eye(4), "mode": "t"}], None,
                                          None, target_label=1),
                 lambda: manipulator_demo(tcfg, {}, {}, (2, 2, np.eye(3)), {}, None, None, [],
                                          np.eye(4)[None], {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
