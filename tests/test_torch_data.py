"""The port's ScanNet and Replica slice on the CPU against the JAX package: the loaders
field by field on fixtures the JAX writers wrote, the numpy nearest-neighbour resize
against OpenCV's INTER_NEAREST, the port's own writers and in-memory builders, the
fixtures' ray geometry, the crop sampler with the JAX sampler's draws injected, the
ScanNet train step with its labelled suffix (N_ins) per step, and a crop-evaluated
render_test view.

Tolerances: loaders, resize, sampler targets and masks exact; sampler rays 1e-6;
train-step losses 1e-4 relative per step for 5 steps and render_test 1e-4, as
tests/test_torch_train.py and tests/test_torch_render.py hold the DM-SR slice."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.core.mlp import init_dm_nerf  # noqa: E402
from dmnerf_tpu.data import replica as jrep  # noqa: E402
from dmnerf_tpu.data import samplers as jsam  # noqa: E402
from dmnerf_tpu.data import scannet as jscan  # noqa: E402
from dmnerf_tpu.data import synthetic as jsyn  # noqa: E402
from dmnerf_tpu.render import evaluation as jeval  # noqa: E402
from dmnerf_tpu.render import renderer as jren  # noqa: E402
from dmnerf_tpu.render import trainstep as jts  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.core.rays import rays_for_pixels  # noqa: E402
from dmnerf_tpu_torch.data import replica as trep  # noqa: E402
from dmnerf_tpu_torch.data import scannet as tscan  # noqa: E402
from dmnerf_tpu_torch.data import synthetic as tsyn  # noqa: E402
from dmnerf_tpu_torch.data.samplers import make_crop_sampler  # noqa: E402
from dmnerf_tpu_torch.data.scene import load_scene  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.render import evaluation as teval  # noqa: E402
from dmnerf_tpu_torch.render import trainstep as tts  # noqa: E402

torch.set_num_threads(2)
FIELDS = ("images", "poses", "H", "W", "K", "i_train", "i_test", "gt_labels", "ins_rgbs",
          "ins_num", "crop_mask", "view_poses", "objs", "ins_map")


def _assert_scenes_equal(got, want, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None or isinstance(w, (list, dict)):
            assert g == w, f
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)
    if want.ins_indices is None:
        assert got.ins_indices is None
    else:
        assert len(got.ins_indices) == len(want.ins_indices)
        for g, w in zip(got.ins_indices, want.ins_indices):
            np.testing.assert_array_equal(g, w)


def _scannet_kw(resize, **kw):
    return dict(dataset_type="scannet", testskip=1, crop_width=24, crop_height=16, resize=resize,
                weakly_value=0.5, seed=3, **kw)


@pytest.fixture(scope="module")
def scannet_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scannet") / "scene0113_00")
    jsyn.write_scannet_scene(d, n_train=4, n_test=3, H=24, W=32, n_objects=3)
    return d


@pytest.fixture(scope="module")
def replica_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("replica") / "room_0")
    jsyn.write_replica_scene(d, H=12, W=16, n_objects=3, ins_num=8, testskip=10)
    return d


@pytest.mark.parametrize("resize", [False, True])
def test_scannet_loader_matches_jax(scannet_dir, resize):
    """load_scannet against the JAX loader on the JAX writer's fixture: every field
    exact, the -1 -> ins_num air remap, the palette cut to ins_num, the crop mask and
    the weakly labelled pixel ids (default_rng(cfg.seed) draws), with and without the
    nearest-neighbour resize to 640x480 (intrinsic_depth.txt vs intrinsic_color.txt)."""
    kw = _scannet_kw(resize, datadir=scannet_dir)
    want = jscan.load_scannet(JConfig(**kw))
    got = tscan.load_scannet(Config(**kw))
    _assert_scenes_equal(got, want)
    assert got.gt_labels.min() >= 0 and (got.gt_labels == got.ins_num).any()
    assert got.images.shape[1:3] == ((480, 640) if resize else (24, 32))
    _assert_scenes_equal(load_scene(Config(**kw)), want)


@pytest.mark.parametrize("view_id", [0, None])
def test_replica_loader_matches_jax(replica_dir, tmp_path, view_id):
    """load_replica against the JAX loader: the fixed 900-frame split after testskip,
    traj_w_c rows, positive K with focal W/2, the palette, and the mani_demo branch:
    poses[view_id] repeated, or the spherical path over linspace(-180, 180)."""
    d = replica_dir
    if view_id is None:
        d = str(tmp_path / "room_0")
        import shutil

        shutil.copytree(replica_dir, d)
        with open(os.path.join(d, "objs_info.json")) as f:
            info = json.load(f)
        info["view_id"] = None
        with open(os.path.join(d, "objs_info.json"), "w") as f:
            json.dump(info, f)
    for demo in (False, True):
        kw = dict(dataset_type="replica", datadir=d, testskip=10, mani_demo=demo, views=5)
        want = jrep.load_replica(JConfig(**kw))
        got = trep.load_replica(Config(**kw))
        _assert_scenes_equal(got, want)
        _assert_scenes_equal(load_scene(Config(**kw)), want)
    assert got.K[0, 0] == 8.0 and got.K[0, 2] == 7.5 and got.K[2, 2] == 1.0
    assert len(got.i_train) == 180 and len(got.i_test) == 18 and got.view_poses.shape == (5, 4, 4)


@pytest.mark.parametrize("shape", [(968, 1296, 480, 640), (37, 53, 480, 640), (481, 641, 123, 77)])
def test_resize_nearest_matches_cv2(shape):
    """The numpy index map equals cv2.resize(..., INTER_NEAREST) on int32 labels (with
    -1) and float32 images, at ScanNet's 1296x968 -> 640x480 and two odd ratios."""
    cv2 = pytest.importorskip("cv2")
    h, w, H, W = shape
    rng = np.random.default_rng(0)
    labels = rng.integers(-1, 40, (2, h, w)).astype(np.int32)
    images = rng.random((2, h, w, 3)).astype(np.float32)
    for data in (labels, images):
        got = tscan.resize_nearest(data, H, W)
        want = np.stack([cv2.resize(d, (W, H), interpolation=cv2.INTER_NEAREST) for d in data])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_port_writers_and_builders_match(tmp_path):
    """The port's writers write what the JAX writers write (the same draws), so the
    port's loader on its own fixtures equals the JAX loader on the JAX fixtures; the
    in-memory builders give the loaders' SceneData (ScanNet's without the JPEG loss)."""
    kw = _scannet_kw(False, datadir=str(tmp_path / "scannet_j"))
    jsyn.write_scannet_scene(kw["datadir"], n_train=3, n_test=2, H=24, W=32, n_objects=3, seed=1)
    tsyn.write_scannet_scene(str(tmp_path / "scannet_t"), n_train=3, n_test=2, H=24, W=32,
                             n_objects=3, seed=1)
    want = jscan.load_scannet(JConfig(**kw))
    _assert_scenes_equal(tscan.load_scannet(Config(**{**kw, "datadir": str(tmp_path / "scannet_t")})),
                         want)
    built = tsyn.build_scannet_scene(Config(**kw), n_train=3, n_test=2, H=24, W=32, n_objects=3,
                                     seed=1)
    _assert_scenes_equal(built, want, tuple(f for f in FIELDS if f != "images"))
    assert np.abs(built.images - want.images).mean() < 0.05       # the JPEG loss only

    kw = dict(datadir=str(tmp_path / "replica_j"), testskip=20, mani_demo=True, views=3)
    jsyn.write_replica_scene(kw["datadir"], H=10, W=12, n_objects=2, ins_num=5, seed=2, testskip=20)
    tsyn.write_replica_scene(str(tmp_path / "replica_t"), H=10, W=12, n_objects=2, ins_num=5,
                             seed=2, testskip=20)
    want = jrep.load_replica(JConfig(**kw))
    _assert_scenes_equal(trep.load_replica(Config(**{**kw, "datadir": str(tmp_path / "replica_t")})),
                         want)
    _assert_scenes_equal(tsyn.build_replica_scene(Config(**kw), H=10, W=12, n_objects=2, ins_num=5,
                                                  seed=2), want)


def _assert_fixture_ray_geometry(scene, spec, label_of_sphere, n_imgs=2):
    """The port loader's rays, cast at labelled pixels, hit the sphere the label names:
    pins the (intrinsics, pose convention) pair of a fixture against its renders
    (tests/test_data_and_train.py:105-144)."""
    air = scene.ins_num

    def first_hit_label(o, dvec):
        dn = dvec / np.linalg.norm(dvec)
        best_t, lab = np.inf, air
        for k in range(len(spec["radii"])):
            oc = o - spec["centers"][k]
            b = float(np.dot(oc, dn))
            disc = b * b - (float(np.dot(oc, oc)) - float(spec["radii"][k]) ** 2)
            if disc <= 0:
                continue
            t = -b - np.sqrt(disc)
            if 1e-3 < t < best_t:
                best_t, lab = t, label_of_sphere(k)
        return lab

    rng = np.random.RandomState(0)
    checked = 0
    for img_i in scene.i_train[:n_imgs]:
        labs = scene.gt_labels[img_i]
        ys, xs = np.where((labs != air) & (labs != label_of_sphere(-1)))
        sel = rng.choice(len(ys), size=min(20, len(ys)), replace=False)
        ro, rd = rays_for_pixels(torch.from_numpy(ys[sel]), torch.from_numpy(xs[sel]),
                                 torch.from_numpy(scene.K), torch.from_numpy(scene.poses[img_i]))
        for j in range(len(sel)):
            want = int(labs[ys[sel][j], xs[sel][j]])
            assert first_hit_label(ro[j].numpy(), rd[j].numpy()) == want, (img_i, j, want)
            checked += 1
    assert checked >= 30


def test_scannet_fixture_ray_geometry_consistent(tmp_path):
    d = str(tmp_path / "scene0114_00")
    spec = tsyn.write_scannet_scene(d, n_train=4, n_test=2, H=32, W=40, n_objects=3,
                                    unlabeled_frac=0.0)
    scene = tscan.load_scannet(Config(datadir=d, testskip=1, crop_width=40, crop_height=32))
    _assert_fixture_ray_geometry(scene, spec, label_of_sphere=lambda k: k)


def test_replica_fixture_ray_geometry_consistent(tmp_path):
    d = str(tmp_path / "replica_room")
    spec = tsyn.write_replica_scene(d, H=32, W=40, n_objects=3, ins_num=8, testskip=10)
    scene = trep.load_replica(Config(datadir=d, testskip=10))
    _assert_fixture_ray_geometry(scene, spec, label_of_sphere=lambda k: k + 1)


def _jax_draws(key, n_train, ins_indices, crop_mask, T):
    """The draws the JAX crop sampler makes from ``key`` (dmnerf_tpu/data/samplers.py:
    94-110): the image slot, the labelled-table slots and the rgb pixel ids."""
    n_ins = int(n_train * 0.3)
    L = max(max(len(ix) for ix in ins_indices), n_ins)
    counts = np.array([len(ix) for ix in ins_indices])
    crop_flat = jnp.asarray(np.where(crop_mask.reshape(-1) == 1)[0].astype(np.int32))
    k_img, k_lab, k_rgb = jax.random.split(key, 3)
    t = int(jax.random.randint(k_img, (), 0, T))
    valid = jnp.arange(L) < counts[t]
    _, top = jax.lax.top_k(jax.random.uniform(k_lab, (L,)) + jnp.where(valid, 0.0, -1e9), n_ins)
    rgb_ids = jax.random.choice(k_rgb, crop_flat, (n_train - n_ins,), replace=False)
    return t, np.asarray(top), np.asarray(rgb_ids)


@pytest.fixture(scope="module")
def crop_scene():
    cfg = Config(crop_width=16, crop_height=12, weakly_value=1.0)
    return tsyn.build_scannet_scene(cfg, n_train=3, n_test=1, H=16, W=20, n_objects=3, seed=0)


@pytest.mark.parametrize("labelled", ["scene", "under"])
def test_crop_sampler_matches_jax_with_injected_draws(crop_scene, labelled):
    """With the JAX sampler's draws injected, the port's batch equals the JAX batch:
    rays at 1e-6, targets and target_valid exact; labelled rays are the suffix. 'under'
    gives every image 3 labelled pixels, fewer than N_ins: exactly those 3 suffix slots
    are valid (tests/test_data_and_train.py:231-252)."""
    s = crop_scene
    ins = s.ins_indices if labelled == "scene" else [np.array([5, 99, 200]) for _ in s.i_train]
    n_train = 40
    jsample, jn = jsam.make_crop_sampler(s.images, s.gt_labels, s.poses, s.K, s.i_train, n_train,
                                         ins, s.crop_mask)
    tsample, tn = make_crop_sampler(s.images, s.gt_labels, s.poses, s.K, s.i_train, n_train, ins,
                                    s.crop_mask, device="cpu")
    assert tn == jn == 12
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jsample(key)
        t, top, rgb_ids = _jax_draws(key, n_train, ins, s.crop_mask, len(s.i_train))
        got = tsample(t=t, lab_slots=torch.from_numpy(top.copy()),
                      rgb_ids=torch.from_numpy(rgb_ids.copy()))
        for k in ("rays_o", "rays_d"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(got.target_c.numpy(), np.asarray(want.target_c))
        np.testing.assert_array_equal(got.target_i.numpy(), np.asarray(want.target_i))
        np.testing.assert_array_equal(got.target_valid.numpy(), np.asarray(want.target_valid))
    valid = got.target_valid.numpy()
    assert valid[:-tn].all()
    if labelled == "under":
        assert valid[-tn:].sum() == 3

    drawn = tsample(torch.Generator().manual_seed(1))
    assert drawn.target_valid.shape == (n_train,) and drawn.target_valid[:-tn].all()
    suffix = drawn.target_i.numpy()[-tn:][drawn.target_valid.numpy()[-tn:]]
    assert (suffix != s.ins_num).all() if labelled == "scene" else len(suffix) == 3


def test_ins_criterion_with_air_in_padded_slots_matches_jax():
    """The crop sampler's padded suffix slots read pixel 0, whose label may be the air
    label ins_num; ray_mask pads them out. The port's instance loss equals the JAX
    package's (which drops the out-of-range scatter and clamps the gather) and counts
    no air instance."""
    from dmnerf_tpu.objfield import losses as jl
    from dmnerf_tpu_torch.objfield import losses as tl

    rng = np.random.RandomState(7)
    C, N = 5, 30
    labels = rng.randint(0, C, N).astype(np.int32)
    mask = np.ones(N, bool)
    labels[-6:], mask[-6:] = C, False
    pred = rng.uniform(0.02, 0.98, (N, C)).astype(np.float32)
    got = tl.ins_criterion(torch.from_numpy(pred)[None], torch.from_numpy(labels), C,
                           torch.from_numpy(mask))
    want = jl.ins_criterion(jnp.asarray(pred), jnp.asarray(labels), C, jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g[0]), float(w), atol=1e-5, rtol=1e-5)
    gt, valid, present = tl.compact_one_hot(torch.from_numpy(labels), C, torch.from_numpy(mask))
    jgt, jvalid, jpresent = jl.compact_one_hot(jnp.asarray(labels), C, jnp.asarray(mask))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    assert int(valid) == int(jvalid) and not gt[-6:].any()
    np.testing.assert_array_equal(present.numpy(), np.asarray(jpresent))


TINY = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
            N_samples=8, N_importance=8, N_train=64, N_test=128, near=2.0, far=7.0,
            lrate=5e-3, lrate_decay=500, perturb=0.0, penalize=True, tolerance=0.05, deta_w=0.05,
            crop_width=16, crop_height=12)


def test_scannet_train_steps_match_jax(crop_scene):
    """5 steps of the JAX make_train_step(cfg, N_ins) and of the port's (pe_mode
    'outside': K7's, K5's and K6's plain versions on the CPU) from the same parameters
    on the same crop-sampler batches: the instance loss over the labelled suffix with
    its padding mask, each loss within 1e-4 relative per step."""
    s = crop_scene
    kw = dict(TINY, ins_num=s.ins_num)
    sample, n_ins = make_crop_sampler(s.images, s.gt_labels, s.poses, s.K, s.i_train,
                                      kw["N_train"], s.ins_indices, s.crop_mask, device="cpu")
    assert n_ins == 19
    gen = torch.Generator().manual_seed(0)
    batches = [sample(gen) for _ in range(5)]
    jcfg = JConfig(**kw)
    jstate = jts.create_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jts.make_train_step(jcfg, N_ins=n_ins)
    cfg = Config(pallas_pe_mode="outside", **kw)
    to_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731
    state = tts.create_train_state(cfg, params_from_numpy(to_np(jstate.params_coarse), "cpu"),
                                   params_from_numpy(to_np(jstate.params_fine), "cpu"))
    step = tts.make_train_step(cfg, N_ins=n_ins)
    runtime.reset_launches()
    for i, b in enumerate(batches):
        aux = step(state, b)
        jstate, jaux = jstep(jstate, jts.Batch(*(jnp.asarray(t.numpy()) for t in b)),
                             jax.random.PRNGKey(0))
        for k in ("total_loss", "rgb_loss", "ins_loss", "emptiness_loss"):
            assert np.isfinite(float(aux[k]))
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
    assert not any(runtime.LAUNCHES.values())


def test_train_entry_point_takes_the_crop_sampler(crop_scene, tmp_path, monkeypatch):
    """train() on a scene with a crop mask and labelled ids uses the crop sampler and
    hands its N_ins to the train step; its losses are finite."""
    from dmnerf_tpu_torch import train as ttrain

    seen = {}
    real = ttrain.make_train_step

    def spy(cfg, query_fn=None, N_ins=None):
        seen["N_ins"] = N_ins
        return real(cfg, query_fn, N_ins=N_ins)

    monkeypatch.setattr(ttrain, "make_train_step", spy)
    cfg = Config(basedir=str(tmp_path), expname="scannet", N_iters=2, i_print=1, i_save=10 ** 6,
                 i_test=10 ** 6, pallas_pe_mode="outside", **dict(TINY, ins_num=crop_scene.ins_num))
    state = ttrain.train(cfg, crop_scene, device="cpu")
    assert state.step == 2 and seen["N_ins"] == int(0.3 * cfg.N_train)
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2 and all(np.isfinite(r["ins_loss"]) for r in recs)
    full = Config(**TINY, ins_num=3)
    assert ttrain.make_sampler(full, tsyn.build_dmsr_scene(n_train=2, n_test=1, H=8, W=8), "cpu")[1] is None


KW = dict(N_samples=8, N_importance=8, N_test=64, near=2.0, far=7.0, netdepth=3, netwidth=32,
          multires=10, multires_views=4, skips=(1,), crop_width=16, crop_height=12)


def test_crop_render_test_matches_jax(crop_scene):
    """A crop-evaluated render_test view (the prediction and GT cut to the crop, the
    mAP masked to labels below ins_num) against the JAX one at 1e-4, the port under
    pe_mode 'outside'."""
    s = crop_scene
    kw = dict(KW, ins_num=s.ins_num)

    def params(seed):
        jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=s.ins_num, D=kw["netdepth"],
                          W=kw["netwidth"], skips=kw["skips"])
        return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")

    (jpc, tpc), (jpf, tpf) = params(2), params(3)
    ids = s.i_test
    args = (s.poses[ids], s.hwk)
    ev = dict(gt_imgs=s.images[ids], gt_labels=s.gt_labels[ids], crop_mask=s.crop_mask,
              verbose=False)
    want = jeval.render_test(JConfig(**kw), jpc, jpf, *args,
                             renderer=jren.make_image_renderer(JConfig(**kw)), **ev)
    got = teval.render_test(Config(pallas_pe_mode="outside", **kw), tpc, tpf, *args,
                            device="cpu", **ev)
    for k in ("psnrs", "ssims"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["aps"], want["aps"], atol=1e-6)
    assert got["full_map"] == want["full_map"]
    for g, w in zip(got["images"], want["images"]):
        assert g.shape == (12, 16, 3)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_run_test_renders_a_scannet_scene(tmp_path, monkeypatch):
    """test.py's render mode on a ScanNet tree: the loader, the crop-evaluated
    render_test and its files, on the CPU under pe_mode 'outside'."""
    from dmnerf_tpu_torch.test import run_test

    d = str(tmp_path / "scene0010_00")
    tsyn.write_scannet_scene(d, n_train=2, n_test=1, H=16, W=20, n_objects=2)
    cfg = Config(dataset_type="scannet", datadir=d, basedir=str(tmp_path / "logs"),
                 expname="scannet", render=True, render_test=True, pallas_pe_mode="outside",
                 testskip=1,
                 **{k: v for k, v in KW.items()})
    run_test(cfg, device="cpu")
    out = os.path.join(cfg.log_dir, "render_test_000000")
    assert os.path.exists(os.path.join(out, "000.png"))
    with open(os.path.join(out, "test_results.txt")) as f:
        assert len(f.read().splitlines()) >= 2
