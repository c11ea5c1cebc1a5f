"""The port's command-line cycle on the CPU (``scripts/e2e_cycle_torch.py``, ``--device
cpu``) at a tiny size, and what it rests on.

- Each family's cycle: the scene written, ``python -m dmnerf_tpu_torch.train`` killed by
  SIGTERM at its first checkpoint and relaunched, the restored state bit for bit the
  checkpoint file's, the test modes' files from the trained step (``render``; for DM-SR
  also ``mani_eval``, ``mani_demo``, ``mesh``).
- A resume of the port from the JAX package's checkpoint against the JAX package's own
  resume, on the one-view 7x9 scene where every step sees every pixel: the losses within
  1e-4 relative (the train-step bar of ``tests/test_torch_train.py``, 5 steps).
- The rules around a resume: a stray ``<step>.pt.tmp`` is never restored; a run resumed
  off a pack boundary takes single steps to the next one, then packs.
- The file I/O the card's host needs without imageio or h5py: the port's HDF5 codec
  against h5py both ways, its images against imageio's bytes and arrays.
- The train command line's ``--device`` and its ``[report]`` lines.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import shutil
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dmnerf_tpu_torch import train as ttrain  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.data import synthetic as tsyn  # noqa: E402
from dmnerf_tpu_torch.render.packing import StepRunner  # noqa: E402
from dmnerf_tpu_torch.render.trainstep import create_train_state  # noqa: E402
from dmnerf_tpu_torch.test import init_params  # noqa: E402
from dmnerf_tpu_torch.utils import hdf5  # noqa: E402
from dmnerf_tpu_torch.utils.checkpoint import (  # noqa: E402
    checkpoint_steps, resolve_ckpt_path, restore_checkpoint, save_checkpoint, state_digest)
from dmnerf_tpu_torch.utils.image_io import imread, imwrite  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the model and sampling of the CPU cycle, as config keys on top of the shipped configs
TINY_KEYS = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
                 N_samples=8, N_importance=8, N_train=64, N_test=256)
TINY = dict(TINY_KEYS, N_test=128, near=2.0, far=7.0, lrate=5e-3, lrate_decay=500, perturb=1.0,
            penalize=True, tolerance=0.05, deta_w=0.05)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def e2e():
    return _script("e2e_cycle_torch")


def _tiny_cycle(e2e, family):
    """The smoke cycle of ``family`` at 16² (ScanNet 24x32, a 24x16 crop), 14 iterations,
    a checkpoint after every 5, a 20³ mesh."""
    c = e2e.cycle(family, "smoke")
    H, W = (24, 32) if family == "scannet" else (16, 16)
    keys = dict(c.keys, **TINY_KEYS)
    if family == "scannet":
        keys.update(crop_width=24, crop_height=16)
    return dataclasses.replace(c, scene=dict(c.scene, H=H, W=W), iters=14, i_save=5, i_print=2,
                               keys=keys, mesh_grid_dim=20, mesh_level=0.08, timeout=600.0)


@pytest.mark.parametrize("family", ["dmsr", "replica", "scannet"])
def test_cli_cycle_trains_kills_resumes_and_tests(e2e, family, tmp_path):
    c = _tiny_cycle(e2e, family)
    rec = e2e.run_cycle(c, str(tmp_path), "cpu")
    assert rec["failures"] == []
    res = rec["resume"]
    assert res["killed_rc"] == -signal.SIGTERM
    assert res["newest_checkpoint"] in (6, 11) and res["stray_files"] == []
    assert res["resumed_line_step"] == res["report_step"] == res["newest_checkpoint"]
    assert res["digest_restored"] == res["digest_file"] and res["bits_equal"]
    assert res["ok"] and rec["train"]["final_checkpoint"] == c.iters

    log_dir = rec["log_dir"]
    steps = [r["step"] for r in e2e._records(log_dir)]
    before = [s for s in steps if s <= res["last_before_kill"]["step"]]
    assert steps == before + list(range(res["first_after_resume"]["step"], c.iters, 2))
    assert res["first_after_resume"]["step"] == res["newest_checkpoint"] + res["newest_checkpoint"] % 2

    modes = rec["modes"]
    want = {"render", "render_init"} | ({"mani_eval", "mani_demo", "mesh"} if family == "dmsr" else set())
    assert set(modes) == want
    assert all(m["loaded_step"] == c.iters for k, m in modes.items() if k != "render_init")
    assert modes["render_init"]["loaded_step"] is None
    for step in (c.iters, 0):
        (path,) = glob.glob(os.path.join(log_dir, f"render_*_{step:06d}", "test_results.txt"))
        assert np.loadtxt(path).shape == (modes["render"]["views"] + 1, 9)
        assert len(glob.glob(os.path.join(os.path.dirname(path), "instance_*.png"))) \
            == modes["render"]["views"]
    if family == "dmsr":
        mani = os.path.join(log_dir, f"mani_eval_{c.iters:06d}", "translation")
        assert os.path.exists(os.path.join(mani, "test_results.txt"))
        assert len(glob.glob(os.path.join(mani, "*_rgb.png"))) == modes["mani_eval"]["views"]
        demo = os.path.join(log_dir, f"mani_demo_{c.iters:06d}", "mani_output")
        assert sorted(os.listdir(demo)) == sorted(f"{i}_{k}.png" for i in range(c.demo_views)
                                                  for k in ("rgb", "ins", "ins_pred_mask"))
        assert sorted(modes["mesh"]["files"]) == ["color_mesh.ply", "mesh.ply"]
        assert modes["mesh"]["clean_verts"] > 0 and modes["mesh"]["seconds"]["marching"] >= 0
    for path in ("cli_train", "cli_test"):
        launches = rec["launches"][f"{path}_{family}"]
        assert set(launches) >= {"fused_mlp_fwd", "fused_mlp_bwd", "assignment"}
        assert not any(launches.values())      # the CPU runs the plain versions


def test_port_resumes_a_jax_checkpoint_as_jax_resumes_it(tmp_path):
    """Both packages train 10 iterations with a checkpoint at the boundary after 5 (step
    6), then resume from it: JAX from its own Orbax checkpoint, the port from it converted
    (``scripts/orbax_to_torch.py``). The resumed runs log the same losses."""
    pytest.importorskip("jax")
    from dmnerf_tpu import train as jtrain
    from dmnerf_tpu.configs import Config as JConfig
    from dmnerf_tpu.data.scene import SceneData as JSceneData

    scene = tsyn.build_dmsr_scene(n_train=1, n_test=1, H=7, W=9, n_objects=2, ins_num=4, seed=0)
    kw = dict(TINY, ins_num=scene.ins_num, N_train=63, perturb=0.0, N_iters=10, i_print=1,
              i_save=5, i_test=10 ** 6, expname="resume")
    jcfg = JConfig(**kw, basedir=str(tmp_path / "jax"))
    jscene = JSceneData(**dataclasses.asdict(scene))
    jtrain.train(jcfg, jscene)
    ckdir = os.path.join(jcfg.log_dir, "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["000006", "000010"]
    shutil.rmtree(os.path.join(ckdir, "000010"))
    n_first = len(_records(jcfg.log_dir))
    jtrain.train(jcfg, jscene)                               # resumes at step 6
    want = _records(jcfg.log_dir)[n_first:]

    cfg = Config(**kw, basedir=str(tmp_path / "port"))
    _script("orbax_to_torch").convert(jcfg.log_dir, cfg.log_dir, step=6)
    state = ttrain.train(cfg, scene, device="cpu")           # resumes at step 6
    got = _records(cfg.log_dir)
    assert state.step == 10
    assert [r["step"] for r in got] == [r["step"] for r in want] == [6, 7, 8, 9]
    for g, w in zip(got, want):
        for k in ("total_loss", "rgb_loss", "ins_loss", "emptiness_loss"):
            assert abs(g[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1e-3), (g["step"], k, g[k], w[k])


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_a_stray_tmp_checkpoint_is_never_restored(tmp_path):
    """A SIGTERM during ``save_checkpoint`` can leave ``<step>.pt.tmp`` (written, not yet
    renamed); every reader takes the newest complete file."""
    cfg = Config(**TINY, ins_num=4, basedir=str(tmp_path))
    pc, pf = init_params(cfg, "cpu")
    save_checkpoint(cfg.log_dir, pc, pf, 6)
    stray = os.path.join(cfg.log_dir, "checkpoints", "000011.pt.tmp")
    with open(stray, "wb") as f:
        f.write(b"\x80\x02partial")
    assert restore_checkpoint(cfg.log_dir, "cpu")[2] == 6
    assert resolve_ckpt_path(cfg.log_dir)[1] == 6
    assert list(checkpoint_steps(cfg.log_dir)) == [6]
    assert ttrain.train(cfg.replace(N_iters=7, i_save=10 ** 6, i_print=1), _scene(),
                        device="cpu").step == 7


def _scene():
    return tsyn.build_dmsr_scene(n_train=3, n_test=1, H=16, W=16, n_objects=3, ins_num=4, seed=0)


def _same_state(a, b) -> bool:
    for pa, pb in ((a.params_coarse, b.params_coarse), (a.params_fine, b.params_fine)):
        for k in pa:
            sa, sb = a.opt.state[pa[k]], b.opt.state[pb[k]]
            if not torch.equal(pa[k], pb[k]) or not all(torch.equal(sa[m], sb[m]) for m in sa):
                return False
    return a.step == b.step


def test_a_resume_off_a_pack_boundary_steps_singly_to_the_next(tmp_path, monkeypatch):
    """Resumed at step 5 with packs of 2, train() takes step 5 alone, then packs at 6 and
    8 (``pack_ok``: a pack starts on a multiple of P), and ends where five single steps
    from the checkpoint end; at the flagship, a resume at 5001 packs from 5010."""
    scene = _scene()
    cfg = Config(**TINY, ins_num=scene.ins_num, N_iters=5, i_print=2, i_save=10 ** 6,
                 i_test=10 ** 6, steps_per_dispatch=2, basedir=str(tmp_path))
    ttrain.train(cfg, scene, device="cpu")                   # its final checkpoint: step 5
    calls = []
    real = StepRunner.__call__

    def recording(self, state, gen_batch, gen_step):
        calls.append((state.step, self.P))
        return real(self, state, gen_batch, gen_step)

    monkeypatch.setattr(StepRunner, "__call__", recording)
    cfg = cfg.replace(N_iters=10)
    resumed = ttrain.train(cfg, scene, device="cpu")
    assert calls == [(5, 1), (6, 2), (8, 2)]

    assert restore_checkpoint(cfg.log_dir, "cpu")[2] == 10
    monkeypatch.setattr(StepRunner, "__call__", real)
    want = create_train_state(cfg, *init_params(cfg, "cpu"))
    single = StepRunner(cfg, ttrain.make_sampler(cfg, scene, "cpu")[0],
                        ttrain.make_train_step(cfg), "cpu", 1)
    for _ in range(2):                                       # a resume reseeds
        gb, gs = (torch.Generator().manual_seed(cfg.seed + 1),
                  torch.Generator().manual_seed(cfg.seed + 2))
        for _ in range(5):
            single(want, gb, gs)
    assert _same_state(resumed, want)

    flagship = Config(N_iters=10001, i_save=5000, i_print=100, i_test=10 ** 9)
    assert [i for i in range(5001, 5030) if ttrain.pack_ok(flagship, i, 10, True)] == [5010, 5020]


HDF5_ARRAYS = {
    "palette_u8": np.random.RandomState(0).randint(0, 255, (8, 3)).astype(np.uint8),
    "f32": np.random.RandomState(1).randn(5, 3).astype(np.float32),
    "f64_1d": np.random.RandomState(2).randn(7),
    "f16": np.random.RandomState(3).randn(3, 3).astype(np.float16),
    "i32_3d": np.random.RandomState(4).randint(-9, 9, (2, 3, 4)).astype(np.int32),
    "i64": np.arange(40, dtype=np.int64).reshape(20, 2),
    "u16": np.arange(12, dtype=np.uint16).reshape(4, 3) * 5000,
}


@pytest.mark.parametrize("name", sorted(HDF5_ARRAYS))
def test_hdf5_codec_against_h5py_both_ways(name, tmp_path):
    h5py = pytest.importorskip("h5py")
    a = HDF5_ARRAYS[name]
    theirs, ours = str(tmp_path / "theirs.hdf5"), str(tmp_path / "ours.hdf5")
    with h5py.File(theirs, "w") as f:
        f.create_dataset("datasets", data=a)
    got = hdf5.read_dataset(theirs, "datasets")
    assert got.dtype == a.dtype and np.array_equal(got, a)
    hdf5.write_dataset(ours, "datasets", a)
    with h5py.File(ours, "r") as f:
        assert list(f) == ["datasets"]
        back = f["datasets"][:]
    assert back.dtype == a.dtype and np.array_equal(back, a)
    assert np.array_equal(hdf5.read_dataset(ours, "datasets"), a)


def test_hdf5_reader_finds_datasets_in_a_larger_root_and_refuses_what_it_cannot_read(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "many.hdf5")
    with h5py.File(path, "w") as f:              # more names than one symbol node holds
        for i in range(30):
            f.create_dataset(f"d{i:02d}", data=np.full(2, i))
        f.create_dataset("datasets", data=np.ones((4, 3), np.uint8), track_times=True)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        d = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_UINT8,
                            h5py.h5s.create_simple((2, 3)), dcpl=dcpl)
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype=np.uint8).reshape(2, 3))
    assert np.array_equal(hdf5.read_dataset(path, "d29"), [29, 29])
    assert np.array_equal(hdf5.read_dataset(path, "datasets"), np.ones((4, 3), np.uint8))
    assert np.array_equal(hdf5.read_dataset(path, "compact"), np.arange(6).reshape(2, 3))
    with pytest.raises(KeyError, match="no dataset 'nope'"):
        hdf5.read_dataset(path, "nope")
    with h5py.File(path, "w") as f:
        f.create_dataset("datasets", data=np.ones((100, 3)), chunks=(10, 3), compression="gzip")
    with pytest.raises(ValueError, match="filter pipeline"):
        hdf5.read_dataset(path, "datasets")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("datasets", data=np.ones((4, 3)))
    with pytest.raises(ValueError, match="superblock version"):
        hdf5.read_dataset(path, "datasets")


@pytest.mark.parametrize("kind", ["rgb.png", "label.png", "rgb.jpg", "palette.png"])
def test_images_are_imageios_bytes_and_arrays(kind, tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    from PIL import Image

    rng = np.random.RandomState(0)
    rgb = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
    arr = rgb if kind.startswith(("rgb", "palette")) else rng.randint(0, 9, (24, 32)).astype(np.uint8)
    ext = kind.split(".")[1]
    theirs, ours = str(tmp_path / f"theirs.{ext}"), str(tmp_path / f"ours.{ext}")
    if kind == "palette.png":
        Image.fromarray(arr).convert("P").save(theirs)
        assert np.array_equal(imread(theirs), np.asarray(imageio.imread(theirs)))
        return
    imageio.imwrite(theirs, arr)
    imwrite(ours, arr)
    with open(theirs, "rb") as f1, open(ours, "rb") as f2:
        assert f1.read() == f2.read()
    got = imread(ours)
    assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(imageio.imread(theirs)))


def test_train_cli_takes_a_device_and_reports(tmp_path, monkeypatch, capsys):
    scene_dir = str(tmp_path / "scene")
    tsyn.write_dmsr_scene(scene_dir, n_train=2, n_test=1, H=12, W=12, n_objects=2, ins_num=4)
    argv = ["--config", os.path.join(REPO, "configs", "train", "dmsr", "study.txt"),
            f"datadir={scene_dir}", f"basedir={tmp_path}", "expname=cli", "N_iters=3",
            "i_print=1", "i_save=2", "near=1.0", "far=8.0"] + [
        f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}" for k, v in TINY_KEYS.items()]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(argv)
    with pytest.raises(SystemExit, match="--device needs a value"):
        ttrain.main(argv + ["--device"])
    capsys.readouterr()
    ttrain.main(argv + ["--device", "cpu"])                 # no $DMNERF_REPORT: no report
    assert "[report]" not in capsys.readouterr().out
    monkeypatch.setenv("DMNERF_REPORT", "1")
    log_dir = os.path.join(str(tmp_path), "cli", "run")
    ttrain.main(argv[:5] + ["N_iters=5"] + argv[6:] + ["--device", "cpu"])    # resumes at 3
    reports = [json.loads(line[len("[report] "):]) for line in capsys.readouterr().out.splitlines()
               if line.startswith("[report] ")]
    assert [sorted(r) for r in reports] == [["digest", "resumed_step"],
                                             ["launches", "peak_device_gb"]]
    assert reports[0]["resumed_step"] == 3
    payload = torch.load(os.path.join(log_dir, "checkpoints", "000003.pt"), weights_only=True)
    assert reports[0]["digest"] == state_digest(payload["params_coarse"], payload["params_fine"],
                                                payload["opt_state"])
    assert reports[1]["peak_device_gb"] is None and not any(reports[1]["launches"].values())


def test_state_digest_tells_one_flipped_bit():
    pc = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    opt = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.ones(2, 3),
                         "exp_avg_sq": torch.ones(2, 3)}}}
    base = state_digest(pc, {}, opt)
    flipped = pc["w"].clone()
    flipped.view(torch.int32)[0, 0] ^= 1
    assert state_digest({"w": flipped}, {}, opt)["params"] != base["params"]
    opt["state"][0]["step"] = torch.tensor(4.0)
    assert state_digest(pc, {}, opt) == {"params": base["params"],
                                         "adam": state_digest(pc, {}, opt)["adam"]}
    assert state_digest(pc, {}, opt)["adam"] != base["adam"]
