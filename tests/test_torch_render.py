"""dmnerf_tpu_torch render slice vs dmnerf_tpu on the CPU: the image renderer and
render_test at 1e-4 (a round-off difference can move a sample_pdf rank), instance
AP lists to 1e-6, PSNR / SSIM equal, LPIPS on random weights, and the in-memory
DM-SR scene against the written-then-loaded one."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.core.mlp import init_dm_nerf  # noqa: E402
from dmnerf_tpu.core.rays import rays_from_K as j_rays_from_K  # noqa: E402
from dmnerf_tpu.objfield import metrics as jmet  # noqa: E402
from dmnerf_tpu.render import evaluation as jeval  # noqa: E402
from dmnerf_tpu.render import renderer as jren  # noqa: E402
from dmnerf_tpu.utils import image_metrics as jim  # noqa: E402
from dmnerf_tpu_torch.configs import Config as TConfig  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.data.dmsr import load_dmsr  # noqa: E402
from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene, write_dmsr_scene  # noqa: E402
from dmnerf_tpu_torch.objfield import metrics as tmet  # noqa: E402
from dmnerf_tpu_torch.render import evaluation as teval  # noqa: E402
from dmnerf_tpu_torch.render import renderer as tren  # noqa: E402
from dmnerf_tpu_torch.utils import image_metrics as tim  # noqa: E402

torch.set_num_threads(2)
RTOL = dict(atol=1e-4, rtol=1e-4)
KW = dict(N_samples=8, N_importance=8, N_test=64, near=1.0, far=8.0, netdepth=3, netwidth=32,
          multires=10, multires_views=4, skips=(1,), ins_num=6)


def _params(seed):
    jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=KW["ins_num"], D=KW["netdepth"],
                      W=KW["netwidth"], skips=KW["skips"])
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


@pytest.fixture(scope="module")
def scene():
    return build_dmsr_scene(n_train=1, n_test=2, H=12, W=10, n_objects=3, ins_num=KW["ins_num"])


@pytest.mark.parametrize("sigma_only_coarse", [True, False])
def test_image_renderer(scene, sigma_only_coarse):
    (jpc, tpc), (jpf, tpf) = _params(0), _params(1)
    H, W, K = scene.hwk
    ro, rd = j_rays_from_K(H, W, jnp.asarray(K), jnp.asarray(scene.poses[-1]))
    ro, rd = np.array(ro).reshape(-1, 3), np.array(rd).reshape(-1, 3)   # 120 rays: 2 chunks
    want = jren.make_image_renderer(JConfig(**KW), sigma_only_coarse=sigma_only_coarse)(
        jpc, jpf, jnp.asarray(ro), jnp.asarray(rd))
    got = tren.make_image_renderer(TConfig(**KW), sigma_only_coarse=sigma_only_coarse)(
        tpc, tpf, torch.from_numpy(ro), torch.from_numpy(rd))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **RTOL)


def _plain_chunk_loop(cfg, sigma_only_coarse, params_coarse, params_fine, rays_o, rays_d):
    """The chunked render written out step by step: the rays padded to whole chunks, the
    padding rays' directions set to 1, then per chunk the coarse pass (the sigma stub and
    the fine maps by one reduction, or render_rays) and the maps concatenated."""
    from dmnerf_tpu_torch.core.compositor import composite, composite_maps
    from dmnerf_tpu_torch.core.mlp import sigma_stub_params
    from dmnerf_tpu_torch.core.pipeline import make_query_fn, render_rays
    from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample

    q, chunk, n = make_query_fn(cfg), cfg.N_test, rays_o.shape[0]
    pad = (-n) % chunk
    ro = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
    rd = torch.nn.functional.pad(rays_d, (0, 0, 0, pad))
    z = z_val_sample(chunk, cfg.near, cfg.far, cfg.N_samples)
    pc = q.prepare(sigma_stub_params(params_coarse) if sigma_only_coarse else params_coarse)
    pf = q.prepare(params_fine)
    maps = []
    with torch.no_grad():
        for c0 in range(0, n + pad, chunk):
            o, d = ro[c0:c0 + chunk], rd[c0:c0 + chunk]
            d = torch.where(torch.sum(d * d, -1, keepdim=True) > 0, d, torch.ones_like(d))
            if not sigma_only_coarse:
                info = render_rays(pc, pf, o, d, z, q.query, N_importance=cfg.N_importance,
                                   perturb=False)
                maps.append((info["rgb_fine"], info["ins_fine"], info["depth_fine"]))
                continue
            viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            w = composite(q.query(pc, o[..., None, :] + d[..., None, :] * z[..., :, None],
                                  viewdirs), z, d).weights
            z_fine = torch.sort(torch.cat([z, sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]),
                                                         w[..., 1:-1], cfg.N_importance)], -1),
                                -1).values
            raw_f = q.query(pf, o[..., None, :] + d[..., None, :] * z_fine[..., :, None], viewdirs)
            maps.append(composite_maps(raw_f, z_fine, d, keep_air=False))
    return {k: torch.cat(m)[:n] for k, m in zip(("rgb", "ins", "depth"), zip(*maps))}


@pytest.mark.parametrize("sigma_only_coarse", [True, False])
def test_image_renderer_cpu_stays_eager(scene, monkeypatch, sigma_only_coarse):
    """On the CPU the renderer captures no CUDA graph and runs its chunks one by one: its
    maps equal the chunk loop written out step by step, and ``render_fn.eager``, bit for
    bit, over 2 chunks (the last one padded, its last ray a zero direction)."""
    class NoGraph:
        def __init__(self, *a, **k):
            raise AssertionError("a CUDA graph made for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    (_, tpc), (_, tpf) = _params(4), _params(5)
    H, W, K = scene.hwk
    ro, rd = j_rays_from_K(H, W, jnp.asarray(K), jnp.asarray(scene.poses[0]))
    ro = torch.from_numpy(np.array(ro).reshape(-1, 3))
    rd = torch.from_numpy(np.array(rd).reshape(-1, 3))
    rd[-1] = 0.0
    cfg = TConfig(**KW)
    render = tren.make_image_renderer(cfg, sigma_only_coarse=sigma_only_coarse)
    got = render(tpc, tpf, ro, rd)
    for want in (_plain_chunk_loop(cfg, sigma_only_coarse, tpc, tpf, ro, rd),
                 render.eager(tpc, tpf, ro, rd)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


def test_render_test(scene):
    (jpc, tpc), (jpf, tpf) = _params(2), _params(3)
    ids = scene.i_test
    args = (scene.poses[ids], scene.hwk)
    kw = dict(gt_imgs=scene.images[ids], gt_labels=scene.gt_labels[ids], verbose=False)
    want = jeval.render_test(JConfig(**KW), jpc, jpf, *args,
                             renderer=jren.make_image_renderer(JConfig(**KW)), **kw)
    got = teval.render_test(TConfig(**KW), tpc, tpf, *args, device="cpu", **kw)
    for k in ("psnrs", "ssims"):
        np.testing.assert_allclose(got[k], want[k], **RTOL)
    assert np.all(np.isnan(got["lpipses"])) and np.all(np.isnan(want["lpipses"]))
    np.testing.assert_allclose(got["aps"], want["aps"], atol=1e-6)
    assert got["full_map"] == want["full_map"]
    for g, w in zip(got["images"], want["images"]):
        np.testing.assert_allclose(g, w, **RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_ins_eval_ap_lists(masked):
    rng = np.random.RandomState(4)
    ins_num, H, W = 8, 14, 11
    gt = rng.randint(0, 5, (H, W))
    logits = rng.randn(H, W, ins_num) + 3.0 * np.eye(ins_num)[gt]
    pred = (1 / (1 + np.exp(-logits))).astype(np.float32)
    mask = (rng.rand(H, W) > 0.2).astype(np.float32) if masked else None
    g1, n1, l1 = jmet.compact_gt_one_hot_np(gt, ins_num, drop_last=masked)
    g2, n2, l2 = tmet.compact_gt_one_hot_np(gt, ins_num, drop_last=masked)
    assert n1 == n2 and np.array_equal(g1, g2) and np.array_equal(l1, l2)
    lab1, ap1, _ = jmet.ins_eval(pred, g1, n1, ins_num, mask)
    lab2, ap2, _ = tmet.ins_eval(pred, g2, n2, ins_num, mask)
    np.testing.assert_array_equal(lab1, lab2)
    np.testing.assert_allclose(ap2, ap1, atol=1e-6)
    ious = rng.rand(7)
    conf = rng.rand(7)
    for fs in ("integral", "11point"):
        assert tmet.calculate_ap(ious, 9, conf, fs) == jmet.calculate_ap(ious, 9, conf, fs)


def test_psnr_ssim_equal():
    rng = np.random.RandomState(5)
    a = rng.rand(17, 19, 3).astype(np.float32)
    b = np.clip(a + rng.randn(17, 19, 3).astype(np.float32) * 0.05, 0, 1)
    assert tim.psnr_np(a, b) == jim.psnr_np(a, b)
    assert tim.ssim_np(a, b) == jim.ssim_np(a, b)
    assert tim.ssim_np(a[..., 0], b[..., 0]) == jim.ssim_np(a[..., 0], b[..., 0])
    assert np.array_equal(tim.to8b(a * 1.2), jim.to8b(a * 1.2))


def test_lpips_matches_jax_on_random_weights(tmp_path, monkeypatch):
    from dmnerf_tpu.tools.export_lpips_weights import TAP_CH, VGG16_CONV_CH

    rng = np.random.RandomState(0)
    weights, c_in = {}, 3
    for i, c_out in enumerate(VGG16_CONV_CH):
        weights[f"conv{i}_w"] = (rng.randn(3, 3, c_in, c_out) * 0.2 / np.sqrt(c_in * 9)).astype(np.float32)
        weights[f"conv{i}_b"] = (rng.randn(c_out) * 0.01).astype(np.float32)
        c_in = c_out
    for k, c in enumerate(TAP_CH):
        weights[f"lin{k}_w"] = rng.rand(c).astype(np.float32)
    npz = tmp_path / "lpips_rand.npz"
    np.savez(npz, **weights)
    img = rng.rand(21, 18, 3).astype(np.float32)
    gt = np.clip(img + rng.randn(21, 18, 3).astype(np.float32) * 0.1, 0, 1)
    monkeypatch.delenv("DMNERF_LPIPS_WEIGHTS", raising=False)
    assert np.isnan(tim.lpips_np(img, gt)) and not tim.lpips_available()
    monkeypatch.setenv("DMNERF_LPIPS_WEIGHTS", str(npz))
    got, want = tim.lpips_np(img, gt), jim.lpips_np(img, gt)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_build_dmsr_scene_equals_written_and_loaded(tmp_path):
    from dmnerf_tpu.data.dmsr import load_dmsr as j_load_dmsr
    from dmnerf_tpu.data.synthetic import write_dmsr_scene as j_write_dmsr_scene

    kw = dict(n_train=3, n_test=4, H=14, W=18, n_objects=3, ins_num=6, seed=2)
    write_dmsr_scene(str(tmp_path / "t"), **kw)
    j_write_dmsr_scene(str(tmp_path / "j"), **kw)
    for name in ("objs_info.json", "color_dict.json", os.path.join("test", "transforms.json")):
        with open(tmp_path / "t" / name) as f, open(tmp_path / "j" / name) as g:
            assert f.read() == g.read(), name
    for testskip in (1, 3):
        built = build_dmsr_scene(testskip=testskip, views=5, **kw)
        loaded = load_dmsr(TConfig(datadir=str(tmp_path / "t"), testskip=testskip, views=5))
        j_loaded = j_load_dmsr(JConfig(datadir=str(tmp_path / "j"), testskip=testskip, views=5))
        for field in ("images", "poses", "H", "W", "K", "i_train", "i_test", "gt_labels",
                      "ins_rgbs", "ins_num", "objs", "view_poses", "ins_map", "crop_mask"):
            for other in (loaded, j_loaded):
                a, b = getattr(built, field), getattr(other, field)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b), field
                else:
                    assert a == b, field
