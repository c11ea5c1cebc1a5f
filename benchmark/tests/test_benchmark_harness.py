"""CPU tests of the benchmark's harness: the arithmetic, the result line, the discovery of
cells, metrics and roles by name, and what the benchmark imports. The card test runs a
cell on the card and skips elsewhere."""

from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import registry, run, yardstick
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import (SYNC, WINDOW, Trace, idle_gaps, idle_share, read_chrome_trace,
                             roofline, top_device_ops)

HERE = Path(__file__).resolve().parents[1]
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
LOOSE = {"loss1": 1e-3, "loss": 1e-3, "moment": 1e-3, "change": 1e-3, "rgb_rms": 1e-3, "ins_rms": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_flops_of_a_flagship_step():
    conf = registry.cell("dmsr-study.train")["conf"]
    assert yardstick.point_flops(conf, "full") == 1_391_872
    assert yardstick.point_flops(conf, "sigma") == 982_528
    assert yardstick.train_step_flops(conf) == 2 * 1_391_872 * 786_432 * 3 // 2
    assert round(yardstick.train_step_flops(conf) / 1e9, 1) == 3283.8


def test_union_and_percentile():
    assert yardstick.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert yardstick.merge([(3, 4), (0, 1), (1, 2)]) == [(0, 2), (3, 4)]
    assert yardstick.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)
    assert yardstick.percentile([5.0], 90) == 5.0


def _trace(device, host, t0=0.0, t1=10.0, work=None):
    conf = registry.cell("dmsr-study.train")["conf"]
    work = work or {"steps": 1, "flops": 1e12, "queries": [
        {"points": 1000, "rays": 10, "model": "full", "pass": "fwd"},
        {"points": 1000, "rays": 10, "model": "full", "pass": "bwd"}]}
    return Trace(conf=conf, kind="NVIDIA H100 80GB HBM3", work=work, roles=registry.roles(),
                 device=device, host=host, t0=t0, t1=t1)


def test_roofline_idle_and_breakdown_on_a_hand_made_trace():
    dev = [("void fused_mlp_fwd_kernel<10>(args)", 1.0, 2.0),
           ("bwd_data_kernel", 2.0, 4.0), ("dw_kernel", 4.0, 5.0),
           ("warp_assignment_kernel", 5.0, 5.5), ("elementwise_kernel", 5.5, 6.0),
           ("Memcpy HtoD (Pageable -> Device)", 8.0, 9.0)]
    host = [("aten::randperm", 6.0, 8.0), ("cudaGraphLaunch", 0.0, 1.0),
            ("aten::copy_", 9.0, 10.0), ("outer", 0.0, 10.0)]
    t = _trace(dev, host)
    assert t.busy_s == 6.0
    assert idle_share(t) == pytest.approx(40.0)
    conf = t.conf
    f = yardstick.point_flops(conf) * 1000
    params = 4 * yardstick.n_params(conf)
    io = 4 * (3 * 1000 + 3 * 10)
    fwd_bound = max(f / 989e12, (io + params + 4 * 37 * 1000) / 3.35e12)
    assert roofline(t, "fwd") == pytest.approx(100.0 * fwd_bound / 1.0)
    bwd_bound = max(2 * f / 989e12, (io + 2 * params + 4 * 37 * 1000) / 3.35e12)
    assert roofline(t, "bwd") == pytest.approx(100.0 * bwd_bound / 3.0)
    assert roofline(t, "assignment") is None
    assert t.role_seconds(None) == pytest.approx(1.5)      # the glue and the copy
    assert top_device_ops(t)[0] == ["bwd_data_kernel", 2.0]
    assert top_device_ops(t)[1][0] == "fused_mlp_fwd_kernel<10>"
    gaps = dict(idle_gaps(t))
    assert gaps == {"cudaGraphLaunch": 1.0, "aten::randperm": 2.0, "aten::copy_": 1.0}


@pytest.mark.parametrize("host_ops", [True, False])
def test_the_traced_window_is_the_annotation_else_the_synchronize_calls(tmp_path, host_ops):
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("cuda_runtime", SYNC, 100.0, 5.0), ev("cuda_runtime", "cudaLaunchKernel", 120.0, 4.0),
              ev("kernel", "k", 130.0, 50.0), ev("cuda_runtime", SYNC, 190.0, 10.0)]
    if host_ops:
        events += [ev("user_annotation", WINDOW, 110.0, 92.0), ev("cpu_op", "aten::mm", 118.0, 8.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    device, host, window = read_chrome_trace(str(path))
    assert device == [("k", pytest.approx(130e-6), pytest.approx(180e-6))]
    assert window == (pytest.approx(110e-6), pytest.approx(202e-6)) if host_ops else \
        (pytest.approx(100e-6), pytest.approx(200e-6))
    assert {n for n, _, _ in host} == ({SYNC, "cudaLaunchKernel"} | ({"aten::mm"} if host_ops else set()))


def test_metric_readers_read_nothing_without_device_activity():
    t = _trace([], [("aten::view", 0.0, 1.0)], t1=1.0)
    for m in registry.benchmark()["per_layer"]:
        if m["name"] in ("host_launches_per_view.render",):
            continue
        assert registry.reader("metrics", m["name"])(t) is None, m["name"]


@pytest.mark.parametrize("name,trace", [("dmsr-study.train", False), ("dmsr-study.train", True),
                                        ("scannet-scene0010.train", False),
                                        ("dmsr-study.view", True), ("dmsr-study.mani", False)])
def test_result_line_has_the_contract_keys(name, trace):
    c = tiny_cell(name, width=32, limits={k: v for k, v in LOOSE.items()})
    res = run.run_cell(c, 2 ** 31 + 5, 0.2, trace, torch.device("cpu"))
    keys = list(res)
    assert keys[-1] == "checks"
    assert set(keys[:-1]) <= CONTRACT_KEYS
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert ("breakdown" in res) == trace
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in c["end_to_end"]}
    mine = {k for k in LOOSE if k in res["checks"] and res["checks"][k]["value"] == res["checks"][k]["value"]}
    assert mine and all(res["checks"][k]["value"] < 1e-3 for k in mine)
    json.dumps(res)


def test_a_new_cell_mix_metric_and_role_are_found_by_name(tmp_path):
    here = tmp_path / "benchmark"
    for part in ("configs", "mixes", "metrics", "roles", "e2e", "limits"):
        shutil.copytree(HERE / part, here / part)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    conf = json.loads((here / "configs" / "dmsr-study.json").read_text())
    conf["name"] = "dmsr-other"
    (here / "configs" / "dmsr-other.json").write_text(json.dumps(conf))
    (here / "mixes" / "train-unpacked.json").write_text(json.dumps(
        {"kind": "train", "why": "one step a dispatch", "steps_per_dispatch": 1, "i_print": 10}))
    (here / "metrics" / "k12_roofline.train.py").write_text("def read(t):\n    return 42.0\n")
    (here / "roles" / "fwd-k12.json").write_text(json.dumps(
        {"role": "fwd", "kernels": ["k12_kernel"], "work": None}))
    (here / "limits" / "dmsr-other.train-unpacked.json").write_text(json.dumps({"loss": 1.0}))
    bench["workloads"].append({"name": "dmsr-other.train-unpacked", "config": "dmsr-other",
                               "traffic": "train-unpacked", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("dmsr-other.train-unpacked")
    bench["per_layer"].append({"name": "k12_roofline.train", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "kernels, forward role",
                               "moves": "train_rays_per_s"})
    c = registry.cell("dmsr-other.train-unpacked", bench, here=here)
    assert c["conf"]["name"] == "dmsr-other" and c["mix"]["steps_per_dispatch"] == 1
    assert c["limits"] == {"loss": 1.0}
    assert "k12_roofline.train" in {m["name"] for m in c["per_layer"]}
    assert "mfu.train" not in {m["name"] for m in c["per_layer"]}     # listed cells only
    assert {m["name"] for m in c["end_to_end"]} == {"train_rays_per_s", "setup_s"}
    assert registry.reader("metrics", "k12_roofline.train", here=here)(None) == 42.0
    roles = registry.roles(here=here)
    assert "k12_kernel" in roles["fwd"]["kernels"] and roles["fwd"]["work"] == {"pass": "fwd"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    found = {(p.name, m) for p in HERE.rglob("*.py") for m in _imports(p)
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "dmnerf_tpu")}
    assert not found
    assert any(m.split(".")[0] == "dmnerf_tpu_torch"
               for p in HERE.rglob("*.py") for m in _imports(p))      # the whole name counts


def test_the_reference_imports_nothing_of_the_program():
    found = {(p.name, m) for p in (HERE / "reference").rglob("*.py") for m in _imports(p)
             if m.split(".")[0].startswith("dmnerf")}
    assert not found


def test_a_cell_runs_on_the_card(cuda):
    c = registry.cell("dmsr-study.view")
    res = run.run_cell(c, 7, 1.0, False, cuda)
    assert res["correct"] and res["metrics"]["render_rays_per_s"]["value"] > 0
