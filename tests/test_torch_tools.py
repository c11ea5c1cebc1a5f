"""The port's training tools on the CPU against the JAX package: the Orbax checkpoint
converter (scripts/orbax_to_torch.py over utils.checkpoint.checkpoint_from_numpy),
``profile_dir`` tracing, the NaN hunt, the kernel-vs-plain trajectory parity and the
step profiler.

Tolerances: converted parameters and Adam moments exact; the step after the
conversion within 1e-4 relative of JAX's (the train bar of tests/test_torch_train.py)
and its parameters within 1e-6 + 1e-4 of each parameter's scale; the kernel-vs-plain
trajectory on the CPU, where the fused query is its fp32 plain version, within 1e-5
relative in the losses and 1e-4 dB in PSNR (the head's fused products sum in another
order); the port's run against JAX's run_ours at the train bars: 1e-4 relative a
step, the penalizer alone 2 % (the trajectory bar, tests/test_training_parity.py).
"""

import importlib.util
import json
import os
import pickle
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.render import trainstep as jts  # noqa: E402
from dmnerf_tpu.utils.checkpoint import save_checkpoint as j_save  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.data.samplers import make_full_sampler  # noqa: E402
from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene, write_dmsr_scene  # noqa: E402
from dmnerf_tpu_torch.render import trainstep as tts  # noqa: E402
from dmnerf_tpu_torch.utils.checkpoint import restore_checkpoint  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
            N_samples=8, N_importance=8, N_train=64, N_test=128, near=2.0, far=7.0,
            ins_num=8, lrate=5e-3, lrate_decay=500, perturb=0.0, penalize=True,
            tolerance=0.05, deta_w=0.05)
LOSSES = ("total_loss", "rgb_loss", "ins_loss", "emptiness_loss")


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene():
    return build_dmsr_scene(n_train=4, n_test=1, H=16, W=16, n_objects=3, ins_num=8, seed=0)


def _batches(scene, n):
    rng = np.random.RandomState(0)
    sample = make_full_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                               scene.i_train, TINY["N_train"], device="cpu")
    return [sample(img_i=int(rng.choice(scene.i_train)),
                   pix=torch.from_numpy(rng.choice(16 * 16, TINY["N_train"], replace=False)))
            for _ in range(n)]


def _jbatch(b):
    return jts.Batch(*(jnp.asarray(t.numpy()) for t in b[:4]))


@pytest.fixture(scope="module")
def converted(scene, tmp_path_factory):
    """JAX trains 2 steps and saves with Orbax; the script converts the checkpoint."""
    root = tmp_path_factory.mktemp("convert")
    jcfg = JConfig(**TINY)
    jstate = jts.create_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jts.make_train_step(jcfg)
    batches = _batches(scene, 3)
    for b in batches[:2]:
        jstate, _ = jstep(jstate, _jbatch(b), jax.random.PRNGKey(0))
    j_save(str(root / "jax"), jstate)
    path = _script().convert(str(root / "jax"), str(root / "port"))
    return root, jstate, jstep, batches, path


def _resume_and_step(loaded, batch):
    pc, pf, step, opt = loaded
    state = tts.create_train_state(Config(**TINY), pc, pf, step)
    state.opt.load_state_dict(opt)
    aux = tts.make_train_step(Config(**TINY))(state, batch)
    return state, {k: float(aux[k]) for k in LOSSES}


def test_converted_checkpoint_holds_the_jax_state(converted):
    root, jstate, _, _, path = converted
    assert path == str(root / "port" / "checkpoints" / "000002.pt")
    pc, pf, step, opt = restore_checkpoint(str(root / "port"), "cpu")
    assert step == 2 == int(jstate.step)
    adam = jstate.opt_state[0]
    keys = [(0, k) for k in pc] + [(1, k) for k in pf]
    assert len(opt["state"]) == len(keys) and len(opt["param_groups"]) == 1
    for which, params in ((0, pc), (1, pf)):
        jp = (jstate.params_coarse, jstate.params_fine)[which]
        assert set(params) == set(jp)
        for k, v in params.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jp[k]))
    for i, (which, k) in enumerate(keys):
        s = opt["state"][i]
        assert float(s["step"]) == 2.0
        np.testing.assert_array_equal(s["exp_avg"].numpy(), np.asarray(adam.mu[which][k]))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), np.asarray(adam.nu[which][k]))


def test_next_step_after_conversion_matches_jax(converted):
    root, jstate, jstep, batches, _ = converted
    state, aux = _resume_and_step(restore_checkpoint(str(root / "port"), "cpu"), batches[2])
    jstate2, jaux = jstep(jstate, _jbatch(batches[2]), jax.random.PRNGKey(0))
    assert state.step == 3 == int(jstate2.step)
    for k in LOSSES:
        np.testing.assert_allclose(aux[k], float(jaux[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for ours, want in ((state.params_coarse, jstate2.params_coarse),
                       (state.params_fine, jstate2.params_fine)):
        for k, v in ours.items():
            w = np.asarray(want[k])
            np.testing.assert_allclose(v.detach().numpy(), w, rtol=0,
                                       atol=1e-6 + 1e-4 * float(np.abs(w).max()), err_msg=k)


def test_conversion_places_moments_by_key_not_position(converted):
    """The same tree with every dict in reversed key order converts to the same state:
    one step from either is bit for bit the same."""
    from dmnerf_tpu_torch.utils.checkpoint import checkpoint_from_numpy

    root, _, _, batches, _ = converted
    tree = _script().restore_numpy(str(root / "jax"))
    rev = lambda d: {k: d[k] for k in reversed(list(d))}  # noqa: E731
    adam = tree["opt_state"][0]
    permuted = dict(tree, params_coarse=rev(tree["params_coarse"]),
                    params_fine=rev(tree["params_fine"]),
                    opt_state=[dict(adam, mu=[rev(m) for m in adam["mu"]],
                                    nu=[rev(n) for n in adam["nu"]])] + list(tree["opt_state"][1:]))
    a = checkpoint_from_numpy(tree)
    b = checkpoint_from_numpy(permuted)
    assert list(b[0]) == list(reversed(list(a[0])))
    sa, auxa = _resume_and_step(a, batches[2])
    sb, auxb = _resume_and_step(b, batches[2])
    assert auxa == auxb
    for k in sa.params_fine:
        assert torch.equal(sa.params_fine[k], sb.params_fine[k])
        assert torch.equal(sa.params_coarse[k], sb.params_coarse[k])


def test_port_training_resumes_from_the_converted_checkpoint(converted, scene, tmp_path):
    from dmnerf_tpu_torch.train import train

    _, _, _, _, path = converted
    cfg = Config(**{**TINY, "N_iters": 4, "i_print": 1, "i_save": 10 ** 6, "i_test": 10 ** 6,
                    "basedir": str(tmp_path), "expname": "resumed", "ft_path": path})
    assert train(cfg, scene, device="cpu").step == 4
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 3]
    assert all(np.isfinite(r["total_loss"]) for r in recs)


def test_profile_dir_writes_a_trace_on_the_cpu(scene, tmp_path, capsys):
    """A window that runs past the last step is closed at the end of the run."""
    from dmnerf_tpu_torch.train import train

    cfg = Config(**{**TINY, "N_iters": 3, "i_print": 10, "i_save": 10 ** 6, "i_test": 10 ** 6,
                    "basedir": str(tmp_path), "expname": "p",
                    "profile_dir": str(tmp_path / "trace"), "profile_start": 1,
                    "profile_steps": 5})
    train(cfg, scene, device="cpu")
    path = tmp_path / "trace" / "train_steps_000001-000002.json"
    assert f"wrote profiler trace to {path}" in capsys.readouterr().out
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


_COMPONENT = re.compile(r"^(\w+): value=(\S+) nan_grads=\[(.*)\]$")


def _bad_components(lines):
    bad = set()
    for line in lines:
        m = _COMPONENT.match(line.strip())
        if m and (not np.isfinite(float(m.group(2))) or m.group(3)):
            bad.add(m.group(1))
    return bad


def test_nan_hunt_finds_the_step_and_components_of_the_jax_tool(tmp_path, capsys, monkeypatch):
    """One NaN weight in the fine model's first trunk layer: both tools stop at the same
    first step and name the same non-finite components; both repros load as
    ((params_coarse, params_fine), batch, step_draws, all_info) of numpy arrays."""
    from dmnerf_tpu.tools import nan_hunt as jnh
    from dmnerf_tpu_torch.data.scene import load_scene
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.tools.nan_hunt import hunt

    datadir = tmp_path / "scene"
    write_dmsr_scene(str(datadir), n_train=3, n_test=1, H=16, W=16, n_objects=3, ins_num=8)
    kw = {**TINY, "perturb": 1.0, "datadir": str(datadir), "basedir": str(tmp_path / "logs")}
    conf = tmp_path / "nan.txt"
    conf.write_text("\n".join(f"{k} = {' '.join(map(str, v)) if isinstance(v, tuple) else v}"
                              for k, v in kw.items() if k != "penalize") + "\npenalize\n")

    orig = jts.create_train_state

    def nan_state(cfg, key):
        st = orig(cfg, key)
        pf = dict(st.params_fine)
        pf["trunk_0_w"] = pf["trunk_0_w"].at[0, 0].set(jnp.nan)
        return st._replace(params_fine=pf)

    monkeypatch.setattr(jts, "create_train_state", nan_state)
    jnh.main(["--config", str(conf), "--max-steps", "3", "--repro-out", str(tmp_path / "j.pkl")])
    jout = capsys.readouterr().out.splitlines()

    cfg = Config(**kw)
    pc, pf = init_params(cfg, "cpu")
    pf["trunk_0_w"][0, 0] = float("nan")
    res = hunt(cfg, load_scene(cfg), "cpu", max_steps=3, repro_out=str(tmp_path / "t.pkl"),
               params=(pc, pf))
    tout = capsys.readouterr().out.splitlines()

    first = [int(m.group(1)) for m in map(re.compile(r"first bad step: (\d+)").match, jout) if m]
    assert first == [res["first_bad_step"]] == [0]
    assert _bad_components(jout) == _bad_components(tout) == \
        {k for k, v in res["components"].items() if v["nan_grads"] or not np.isfinite(v["value"])}
    assert "fine.trunk_0_w" in res["components"]["rgb"]["nan_grads"]

    with open(tmp_path / "j.pkl", "rb") as f:
        (jpc, jpf), jb, _, jinfo = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        (tpc, tpf), tb, draws, tinfo = pickle.load(f)
    assert set(tpc) == set(jpc) and set(tpf) == set(jpf) and set(tinfo) == set(jinfo)
    assert all(isinstance(v, np.ndarray) for v in [*tpc.values(), *tinfo.values()])
    for field in ("rays_o", "rays_d", "target_c", "target_i"):
        assert getattr(tb, field).shape == getattr(jb, field).shape
    assert np.isnan(tpf["trunk_0_w"][0, 0]) and np.isnan(jpf["trunk_0_w"][0, 0])
    assert set(draws) == {"u_z", "u_pdf"} and draws["u_z"].shape == (64, 8)


def test_train_parity_kernel_vs_plain_on_the_cpu(tmp_path):
    from dmnerf_tpu_torch.tools import train_parity as tp

    res = tp.run_query_parity(3, 1, "tiny", device="cpu")
    assert [r["iter"] for r in res["rows"]] == [1, 2, 3]
    for r in res["rows"]:
        assert abs(r["psnr_ours"] - r["psnr_ref"]) <= 1e-4
        for k in ("ins", "pen", "total"):
            assert abs(r[f"{k}_ours"] - r[f"{k}_ref"]) <= 1e-5 * abs(r[f"{k}_ref"]), (k, r)
        # the bf16 control within the JAX package's kernel-trajectory bars
        assert abs(r["psnr_ctl"] - r["psnr_ref"]) <= 0.1
        assert abs(r["total_ctl"] - r["total_ref"]) <= 0.02 * abs(r["total_ref"])
    assert res["gap_ours"]["psnr"] <= 1e-4 < res["gap_ctl"]["psnr"]
    assert abs(res["eval_ours"]["psnr"] - res["eval_ref"]["psnr"]) <= 1e-4
    assert res["eval_ours"]["ap"] == res["eval_ref"]["ap"]
    assert abs(res["eval_ctl"]["psnr"] - res["eval_ref"]["psnr"]) <= 0.3
    tp.write_report(res, str(tmp_path / "p.md"))
    report = (tmp_path / "p.md").read_text()
    assert "| 3 |" in report and "| bf16 plain query (control) |" in report


def test_train_parity_control_query_gradient():
    """The control query (K1/K2's plain versions at bf16) against the fp32 plain
    query: the same forward within bf16 rounding, and per parameter a gradient within
    10 % in norm (5.4 % the largest at this size), zero where the fp32 one is zero."""
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.tools import train_parity as tp

    _, cfg = tp.build_scene("tiny")
    _, pf = init_params(cfg, "cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in pf.items()}
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.uniform(-2, 2, (16, 8, 3)).astype(np.float32))
    d = rng.randn(16, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))
    w = torch.as_tensor(rng.randn(16, 8, 4 + cfg.ins_num + 1).astype(np.float32))

    def run(query):
        out = tp._query_fn(cfg, query)(params, pts, d)
        return out.detach(), torch.autograd.grad((out * w).sum(), list(params.values()))

    o32, g32 = run("plain")
    o16, g16 = run("control")
    assert float((o16 - o32).abs().max()) <= 1e-2 * float(o32.abs().max())
    for k, a, b in zip(params, g32, g16):
        assert float((a - b).norm()) <= 0.1 * float(a.norm()), k


def test_train_parity_ours_matches_jax_run_ours(tmp_path):
    """The port's run (the fused query's plain version) against the JAX tool's run_ours
    (its XLA query) on the JAX tool's scene, init and batches, 3 iterations."""
    from dmnerf_tpu.tools import train_parity as jtp
    from dmnerf_tpu_torch.tools import train_parity as tp

    jtp.set_geometry("tiny")
    jscene, pc, pf, record_at, batches = jtp._shared_setup(3, 1, str(tmp_path), 0)
    want = jtp.run_ours(pc, pf, jscene, batches, record_at, query="xla")

    scene, cfg = tp.build_scene("tiny")
    for k in ("images", "poses", "K", "gt_labels", "i_train", "i_test"):
        np.testing.assert_array_equal(getattr(scene, k), getattr(jscene, k), err_msg=k)
    ours_batches = tp.precompute_batches(scene, 3, cfg.N_train, 0)
    for a, b in zip(ours_batches, batches):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
    got = tp.run_ours(cfg, pc, pf, scene, batches, record_at, "kernel", "cpu")
    for it, row in want["trace"].items():
        for k, v in row.items():
            # the penalizer's window switches where a sample crosses depth - tolerance:
            # its gap here is 1.1e-4 relative at iteration 2 (9e-7 and 6e-7 at 1 and 3),
            # so it is held at about 5x that; the total it enters stays at the step bar
            rtol = 5e-4 if k == "emptiness" else 1e-4
            np.testing.assert_allclose(got["trace"][it][k], v, rtol=rtol, err_msg=f"{it} {k}")
    np.testing.assert_allclose(got["eval"]["psnr"], want["eval"]["psnr"], rtol=1e-4)
    assert got["eval"]["ap"] == want["eval"]["ap"]


def test_profile_step_tables_on_the_cpu(capsys):
    """Every mode at a small size on the CPU (host clock): the timers, the kernel
    query against the plain one, and the op tables without device columns."""
    from dmnerf_tpu_torch.tools import profile_step as ps

    dev = torch.device("cpu")
    assert "PE+MLP fine (kernel query, packed)" in ps.profile_stages(4, 4, 1, dev)
    assert "grad rgb+ins+pen (kernel)" in ps.profile_backward(4, 4, 1, dev)
    k = ps.profile_kernel(4, 4, 1, dev)
    assert k["worst_grad_rel_err"] <= 2e-2 and abs(k["value_kernel"] - k["value_plain"]) \
        <= 1e-4 * abs(k["value_plain"])
    ops = ps.profile_ops(4, 4, 5, dev, chunk=8)
    for t in ops.values():
        assert t["top_host"] and "device_ms" not in t and t["wall_ms"] > 0
    assert "top ops by host self time" in capsys.readouterr().out
    assert ps._union_ms([(0, 1000), (500, 2000), (3000, 3500)]) == 2.5


# ---- the LPIPS weight exporter (tools/export_lpips_weights.py) ----

def _lpips_state_dicts(seed: int, layout: str):
    """Random torchvision ``vgg16().features`` and ``lpips.LPIPS(net='vgg')`` state
    dicts (numpy), with lpips's keys as ``lin{k}`` or ``lins.{k}``."""
    from dmnerf_tpu_torch.tools.export_lpips_weights import CONV_SEQ_IDX, TAP_CH, VGG16_CONV_CH

    rng = np.random.RandomState(seed)
    vgg, c_in = {}, 3
    for si, c_out in zip(CONV_SEQ_IDX, VGG16_CONV_CH):
        vgg[f"{si}.weight"] = (rng.randn(c_out, c_in, 3, 3) * 0.2 / np.sqrt(c_in * 9)).astype(np.float32)
        vgg[f"{si}.bias"] = (rng.randn(c_out) * 0.01).astype(np.float32)
        c_in = c_out
    key = "lin{}.model.1.weight" if layout == "lin" else "lins.{}.model.1.weight"
    lp = {key.format(k): rng.rand(1, c, 1, 1).astype(np.float32) for k, c in enumerate(TAP_CH)}
    return vgg, lp


@pytest.mark.parametrize("layout", ["lin", "lins"])
def test_lpips_export_converts_like_the_jax_tool(layout):
    from dmnerf_tpu.tools import export_lpips_weights as jexp
    from dmnerf_tpu_torch.tools import export_lpips_weights as texp

    assert (texp.VGG16_CONV_CH, texp.TAP_CH) == (jexp.VGG16_CONV_CH, jexp.TAP_CH)
    vgg, lp = _lpips_state_dicts(1, layout)
    got, want = texp.convert_state_dicts(vgg, lp), jexp.convert_state_dicts(vgg, lp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    with pytest.raises(KeyError, match="lin2"):
        texp.convert_state_dicts(vgg, {k: v for k, v in lp.items()
                                       if k not in ("lin2.model.1.weight", "lins.2.model.1.weight")})


def test_lpips_export_cli_scores_like_jax(tmp_path, monkeypatch, capsys):
    """The CLI's torch-only route writes the .npz that both packages' lpips_np read from
    $DMNERF_LPIPS_WEIGHTS: within 1e-5 of each other on two seeded 32x32 images; without
    lpips and torchvision the other route exits 1, as the JAX tool does."""
    from dmnerf_tpu.utils import image_metrics as jim
    from dmnerf_tpu_torch.tools.export_lpips_weights import main
    from dmnerf_tpu_torch.utils import image_metrics as tim

    vgg, lp = _lpips_state_dicts(2, "lin")
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, tmp_path / "vgg.pt")
    torch.save({k: torch.from_numpy(v) for k, v in lp.items()}, tmp_path / "lpips.pt")
    out = tmp_path / "lpips_vgg.npz"
    assert main([str(out), "--lpips-state", str(tmp_path / "lpips.pt"),
                 "--vgg-state", str(tmp_path / "vgg.pt")]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    monkeypatch.setenv("DMNERF_LPIPS_WEIGHTS", str(out))
    rng = np.random.RandomState(3)
    img = rng.rand(32, 32, 3).astype(np.float32)
    gt = np.clip(img + rng.randn(32, 32, 3).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    got, want = tim.lpips_np(img, gt), jim.lpips_np(img, gt)
    assert np.isfinite(got) and got > 0 and abs(got - want) <= 1e-5, (got, want)
    assert tim.lpips_np(img, img) == pytest.approx(0.0, abs=1e-7)

    monkeypatch.setitem(sys.modules, "lpips", None)        # import lpips raises ImportError
    assert main([str(tmp_path / "other.npz")]) == 1
    assert "--lpips-state/--vgg-state" in capsys.readouterr().err
    assert not (tmp_path / "other.npz").exists()
