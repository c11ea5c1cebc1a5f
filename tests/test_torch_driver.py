"""The port's eval entry point (dmnerf_tpu_torch.test) vs the JAX one on the CPU: render
mode on a 32x32 DM-SR scene, from a port checkpoint converted from the JAX
checkpoint's parameters, reproduces the JAX test_results.txt rows (LPIPS NaN on both
sides, weights absent); plus the checkpoint resolver. The manipulation modes are in
tests/test_torch_manipulator.py, the mesh mode in tests/test_torch_mesh.py."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.render.trainstep import create_train_state  # noqa: E402
from dmnerf_tpu.test import run_test as j_run_test  # noqa: E402
from dmnerf_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from dmnerf_tpu_torch.configs import Config as TConfig  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.data.synthetic import write_dmsr_scene  # noqa: E402
from dmnerf_tpu_torch.test import load_params, run_test  # noqa: E402
from dmnerf_tpu_torch.utils.checkpoint import (  # noqa: E402
    resolve_ckpt_path, restore_checkpoint, save_checkpoint)

torch.set_num_threads(2)
INS = 6
KW = dict(expname="drv", dataset_type="dmsr", N_samples=8, N_importance=8, N_test=256,
          near=1.0, far=8.0, netdepth=2, netwidth=32, multires=4, multires_views=2,
          ins_num=INS, testskip=1, render=True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    datadir = root / "dmsr" / "study"
    write_dmsr_scene(str(datadir), n_train=2, n_test=2, H=32, W=32, n_objects=3, ins_num=INS)
    jcfg = JConfig(basedir=str(root / "jax_logs"), datadir=str(datadir), use_pallas=False, **KW)
    tcfg = TConfig(basedir=str(root / "torch_logs"), datadir=str(datadir), **KW)
    state = create_train_state(jcfg, jax.random.PRNGKey(0))
    j_save_checkpoint(jcfg.log_dir, state)

    def convert(p):
        return params_from_numpy({k: np.asarray(v) for k, v in p.items()}, device="cpu")

    save_checkpoint(tcfg.log_dir, convert(state.params_coarse), convert(state.params_fine), 0)
    return jcfg, tcfg


def test_render_mode_reproduces_jax_results(env):
    jcfg, tcfg = env
    j_run_test(jcfg)
    run_test(tcfg, device="cpu")
    rows = []
    for cfg in (jcfg, tcfg):
        savedir = os.path.join(cfg.log_dir, "render_path_000000")
        rows.append(np.loadtxt(os.path.join(savedir, "test_results.txt")))
        for name in ("matching_log.json", "000.png", "instance_001.png", "1_ins_gt.png"):
            assert os.path.exists(os.path.join(savedir, name)), name
    want, got = rows
    assert got.shape == want.shape == (3, 9)
    assert np.all(np.isnan(got[:, 2])) and np.all(np.isnan(want[:, 2]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_checkpoint_resolution(env, tmp_path, capsys):
    _, tcfg = env
    run = tmp_path / "run"
    pc, pf, _ = load_params(tcfg, device="cpu")
    save_checkpoint(str(run), pc, pf, 7)
    os.replace(run / "checkpoints" / "000007.pt", run / "checkpoints" / "7.pt")   # unpadded
    save_checkpoint(str(run), pc, pf, 12)
    assert restore_checkpoint(str(run), "cpu")[2] == 12
    assert restore_checkpoint(str(tmp_path / "no_such_run"), "cpu") is None
    assert resolve_ckpt_path(str(run)) == (str(run / "checkpoints" / "000012.pt"), 12)
    assert resolve_ckpt_path(str(run / "checkpoints"))[1] == 12
    assert resolve_ckpt_path(str(run / "checkpoints" / "7.pt"))[1] == 7
    pc7, _, step = load_params(tcfg.replace(ft_path=str(run / "checkpoints" / "7.pt")), device="cpu")
    assert step == 7 and all(torch.equal(pc7[k], pc[k]) for k in pc)
    with pytest.raises(FileNotFoundError):
        resolve_ckpt_path(str(run / "checkpoints" / "000042.pt"))
    with pytest.raises(FileNotFoundError):
        resolve_ckpt_path(str(tmp_path / "no_such_run"))
    fresh = tcfg.replace(basedir=str(tmp_path / "empty"))
    _, _, step = load_params(fresh, device="cpu")
    assert step == 0 and "using init params" in capsys.readouterr().out

