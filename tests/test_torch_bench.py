"""The port's bench (``dmnerf_tpu_torch/bench.py``) on the CPU against the JAX bench
(``bench.py``): the fixed batch, the view rays, the manipulation targets, the mesh grid,
the config and the analytic FLOPs equal the JAX bench's exactly, at the flagship
geometry and at a tiny one; every section runs at a tiny width (D 2, W 32, 64 rays, a
16x16 view, a 16^3 grid) and writes the JAX bench's keys (or their listed renames);
the packed section's first 10 losses equal the same 10 steps one at a time, bit for
bit; a failed section or gate is an ``error`` entry and exit code 1; without a card
``main`` raises.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bench as jbench  # noqa: E402
from dmnerf_tpu.core.rays import rays_from_K as j_rays_from_K  # noqa: E402
from dmnerf_tpu.tools.mesh_extract import build_grid as j_build_grid  # noqa: E402
from dmnerf_tpu_torch import bench  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = bench.Geometry(n_rays=64, n_samples=8, n_importance=8, ins_num=8, netdepth=2,
                      netwidth=32, n_test=128, image=16, grid_dim=16, warmup=1, iters=2,
                      windows=2, profile_steps=2, render_reps=1, mesh_reps=1)
GEOMETRIES = {"flagship": bench.FLAGSHIP, "tiny": TINY}
CFG_FIELDS = ("N_train", "N_samples", "N_importance", "N_test", "near", "far", "ins_num",
              "perturb", "penalize", "tolerance", "deta_w", "precision", "netdepth",
              "netwidth", "multires", "multires_views", "skips", "lrate", "lrate_decay")
CPU = torch.device("cpu")
# the JAX bench's keys that name a TPU thing, and the port's names for them (the bench's
# module docstring lists the same)
RENAMES = {"fwd_ms_xla": "fwd_ms_plain", "fwd_ms_pallas": "fwd_ms_kernel",
           "grad_ms_xla": "grad_ms_plain", "grad_ms_pallas": "grad_ms_kernel",
           "bwd_ms_xla_derived": "bwd_ms_plain_derived",
           "bwd_ms_pallas_derived": "bwd_ms_kernel_derived"}


@pytest.fixture(params=list(GEOMETRIES))
def geo(request, monkeypatch):
    """A geometry, with the JAX bench's module constants set to it."""
    g = GEOMETRIES[request.param]
    for name, v in (("N_RAYS", g.n_rays), ("N_SAMPLES", g.n_samples),
                    ("N_IMPORTANCE", g.n_importance), ("INS_NUM", g.ins_num),
                    ("RENDER_H", g.image), ("RENDER_W", g.image)):
        monkeypatch.setattr(jbench, name, v)
    return g


def _jcfg(precision, g):
    """The JAX bench's config; its width and render chunk are not module constants."""
    return jbench._make_cfg(precision).replace(netdepth=g.netdepth, netwidth=g.netwidth,
                                               N_test=g.n_test)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_config_and_flops_equal_the_jax_bench(geo, precision):
    ours, want = bench.make_cfg(precision, geo), _jcfg(precision, geo)
    for f in CFG_FIELDS:
        assert tuple(np.atleast_1d(getattr(ours, f))) == tuple(np.atleast_1d(getattr(want, f))), f
    assert bench.analytic_matmul_flops(ours) == jbench.analytic_matmul_flops(want)


@pytest.mark.parametrize("dense_ins", [False, True])
def test_batch_equals_the_jax_bench(geo, dense_ins):
    got, want = bench.make_batch(dense_ins, geo, CPU), jbench._make_batch(dense_ins)
    for k in ("rays_o", "rays_d", "target_c", "target_i"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    assert got.target_i.dtype == torch.long and got.rays_d.dtype == torch.float32
    assert len(np.unique(got.target_i.numpy())) == (geo.ins_num if dense_ins else 8)


def test_view_rays_targets_and_grid_equal_the_jax_bench(geo):
    H = W = geo.image
    K = jnp.asarray([[300.0, 0, W / 2], [0, -300.0, H / 2], [0, 0, -1.0]])
    jro, jrd = j_rays_from_K(H, W, K, jnp.eye(4))
    jro, jrd = jro.reshape(-1, 3), jrd.reshape(-1, 3)
    ro, rd = bench.view_rays(geo, CPU)
    assert np.array_equal(ro.numpy(), np.asarray(jro)) and np.array_equal(rd.numpy(), np.asarray(jrd))
    for n_targets in (1, 2):
        offs = [jnp.asarray([0.0, 0.25 * (k + 1), 0.0]) for k in range(n_targets)]
        jtar_o = jnp.stack([jro - off for off in offs])
        jtar_d = jnp.broadcast_to(jrd[None], (n_targets,) + jrd.shape)
        tar_o, tar_d, labels = bench.target_bundles(ro, rd, n_targets)
        assert np.array_equal(tar_o.numpy(), np.asarray(jtar_o))
        assert np.array_equal(tar_d.numpy(), np.asarray(jtar_d))
        assert labels == tuple(range(1, n_targets + 1))
    grid = bench.mesh_grid(geo)
    want = j_build_grid(np.eye(4), np.array([1.9, 7.0, 7.0]), geo.grid_dim)
    assert grid.shape == (geo.grid_dim ** 3, 3) and np.array_equal(grid, want)


# ---- the JAX bench's keys, read from its source ----

def _jax_source():
    with open(os.path.join(REPO, "bench.py")) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _keys(fn, var=None):
    """The string keys a function writes: of its dict literals (or, with ``var``, of
    those assigned to ``var``) and of its subscript assignments (to ``var``)."""
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant) and \
                        (var is None or (isinstance(t.value, ast.Name) and t.value.id == var)):
                    keys.add(t.slice.value)
                if var is not None and isinstance(t, ast.Name) and t.id == var \
                        and isinstance(n.value, ast.Dict):
                    keys |= {k.value for k in n.value.keys if isinstance(k, ast.Constant)}
        if var is None and isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys if isinstance(k, ast.Constant)}
    return keys


def test_detail_keys_are_the_jax_bench_keys():
    assert _keys(_function(_jax_source(), "main"), "detail") == set(bench.JAX_DETAIL_KEYS)


@pytest.fixture(scope="module")
def detail():
    """Every section at the tiny geometry on the CPU, as ``main`` runs them."""
    return bench.run(CPU, TINY)


SECTIONS = {"train_fp32": "bench_train", "train_fp32_dense_ins": "bench_train",
            "train_fp32_packed": "bench_train_packed", "render_fp32": "bench_render",
            "mesh_sigma_fp32": "bench_mesh_sigma", "mani_render_fp32": "bench_mani_render",
            "mani_render_fp32_2t": "bench_mani_render", "train_bf16": "bench_train",
            "render_bf16": "bench_render"}


@pytest.mark.parametrize("section", list(SECTIONS))
def test_each_section_writes_the_jax_keys(detail, section):
    want = _keys(_function(_jax_source(), SECTIONS[section]))
    if section != "train_fp32_dense_ins":
        want.discard("n_instances_present")
    got = detail[section]
    assert "error" not in got, got
    assert want <= set(got), want - set(got)
    assert "launches" in got and not any(got["launches"].values())    # no kernel on the CPU
    for k, v in got.items():
        if isinstance(v, float):
            assert np.isfinite(v), (k, v)


def test_kernel_parity_keys_are_the_renamed_jax_keys():
    raw = _keys(_function(_jax_source(), "bench_kernel_parity"))
    want = {RENAMES.get(k, k) for k in raw}
    with open(os.path.join(REPO, "dmnerf_tpu_torch", "bench.py")) as f:
        got = _keys(_function(ast.parse(f.read()), "bench_kernel_parity"))
    assert want <= got, want - got
    assert set(RENAMES) <= raw     # every rename is of a key the JAX bench writes
    assert not set(RENAMES) & got


def test_sections_on_the_cpu(detail):
    """The tiny run: its numbers, the bf16 gate, MFU without a peak, and the kernel
    section, which has nothing to hold on the CPU."""
    assert bench.failures(detail) == ["kernel_parity"]
    assert "CUDA" in detail["kernel_parity"]["error"]
    assert set(bench.JAX_DETAIL_KEYS) <= set(detail)
    assert detail["device_kind"] == "cpu" and detail["power_limit_w"] is None
    t = detail["train_fp32"]
    assert len(t["ms_per_step_windows"]) == TINY.windows
    assert t["ms_per_step"] == float(np.median(t["ms_per_step_windows"]))
    assert t["device_busy_share"] is None and t["device_ms_per_step"] is None
    assert detail["train_fp32_dense_ins"]["n_instances_present"] == TINY.ins_num
    assert detail["train_fp32_dense_ins"]["psnr_at_5_steps"] is None
    assert detail["render_fp32"]["image"] == "16x16" and detail["mesh_sigma_fp32"]["grid"] == "16^3"
    assert detail["mani_render_fp32_2t"]["n_targets"] == 2
    p = detail["bf16_parity"]
    assert p["pass"] is (p["dpsnr_at_5_steps"] < 1.0)
    assert p["dpsnr_at_5_steps"] == abs(detail["train_bf16"]["psnr_at_5_steps"]
                                        - detail["train_fp32"]["psnr_at_5_steps"])
    m = detail["mfu"]
    assert m["peak_bf16_tflops"] is None and m["train_fp32"]["mfu_vs_bf16_peak"] is None
    flops = bench.analytic_matmul_flops(bench.make_cfg("float32", TINY))["train_flops"]
    assert m["train_fp32"]["achieved_tflops"] == flops / (t["ms_per_step"] / 1e3) / 1e12


def test_packed_losses_equal_single_steps_bit_for_bit(detail):
    pk = detail["train_fp32_packed"]
    assert pk["steps_per_dispatch"] == 10 and pk["bits_equal_single"] is True
    assert len(pk["first_pack_losses"]) == 10
    assert pk["first_pack_losses"] == pk["single_step_losses"]
    assert len(set(pk["first_pack_losses"])) > 1       # the steps moved the parameters


def test_mfu_reads_the_peak_of_a_known_card():
    d = {"device_kind": "NVIDIA H100 80GB HBM3", "train_fp32": {"ms_per_step": 20.0}}
    m = bench.mfu(d, bench.FLAGSHIP)
    flops = jbench.analytic_matmul_flops(jbench._make_cfg("float32"))["train_flops"]
    assert m["peak_bf16_tflops"] == 989.0
    assert m["train_fp32"]["mfu_vs_bf16_peak"] == pytest.approx(flops / 0.02 / 989e12)
    assert "train_bf16" not in m
    assert bench.mfu({"device_kind": "NVIDIA H100 PCIe"}, bench.FLAGSHIP)["peak_bf16_tflops"] is None


# ---- main: one line, errors and gates ----

def _fake(name, fail=None, gate=True):
    def fn(*a, **k):
        if name == fail:
            raise RuntimeError(f"{name} broke")
        if name == "bench_kernel_parity":
            return {"pass": gate, "max_abs_err": 1e-3}
        return {"ms_per_step": 10.0, "rays_per_sec": 1.0, "psnr_at_5_steps": 20.0}
    return fn


def _main(monkeypatch, capsys, argv=(), fail=None, gate=True):
    monkeypatch.setattr(bench, "resolve_device", lambda d=None: CPU)
    for name in ("bench_train", "bench_train_packed", "bench_render", "bench_mani_render",
                 "bench_mesh_sigma", "bench_kernel_parity"):
        monkeypatch.setattr(bench, name, _fake(name, fail, gate))
    rc = bench.main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1                 # stdout carries the one line
    return rc, json.loads(out[0])


def test_main_prints_one_line_and_exits_0(monkeypatch, capsys):
    rc, line = _main(monkeypatch, capsys)
    assert rc == 0 and line["metric"] == "train_rays_per_sec" and line["value"] == 1.0
    assert line["unit"] == "rays/s" and line["vs_baseline"] is None
    assert set(bench.JAX_DETAIL_KEYS) <= set(line["detail"])
    assert line["detail"]["bf16_parity"] == {"dpsnr_at_5_steps": 0.0, "pass": True}


@pytest.mark.parametrize("fail", ["bench_mesh_sigma", "bench_train"])
def test_a_section_that_raises_is_an_error_entry_and_exit_1(monkeypatch, capsys, fail):
    rc, line = _main(monkeypatch, capsys, fail=fail)
    d = line["detail"]
    assert rc == 1
    if fail == "bench_mesh_sigma":
        assert d["mesh_sigma_fp32"] == {"error": "RuntimeError('bench_mesh_sigma broke')"}
        assert "error" not in d["render_fp32"] and d["kernel_parity"]["pass"] is True
    else:       # every train section failed, so the gate has nothing to compare
        assert line["value"] is None and "error" in d["train_bf16"]
        assert d["bf16_parity"]["pass"] is False and "mfu" in d


def test_a_failed_gate_exits_1(monkeypatch, capsys):
    rc, line = _main(monkeypatch, capsys, gate=False)
    assert rc == 1 and line["detail"]["kernel_parity"]["pass"] is False


@pytest.mark.parametrize("fail", [None, "bench_kernel_parity"])
def test_kernel_parity_alone(monkeypatch, capsys, fail):
    rc, line = _main(monkeypatch, capsys, ["--kernel-parity"], fail=fail)
    assert line["metric"] == "kernel_parity_max_abs_err"
    assert (rc, line["value"]) == ((1, None) if fail else (0, 1e-3))


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench_train("float32", geo=TINY)


def test_bench_imports_neither_jax_nor_the_jax_bench():
    code = ("import sys\n"
            "import dmnerf_tpu_torch.bench, dmnerf_tpu_torch.tools.export_lpips_weights\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'dmnerf_tpu', 'bench')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
