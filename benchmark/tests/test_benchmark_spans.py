"""CPU tests of the span readers (``benchmark/spans.py`` and the four ``metrics/`` files that
read the program's spans) on hand-made traces and hand-made span records: a gap inside a
span counts and one outside does not, nested spans count once, the window clips, and
without records or without the program's spans module each reads None. One test puts the
spans of a real view, profiled on the CPU, on the exported trace's clock."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from benchmark import registry, spans as bspans
from benchmark.trace import Trace, read_chrome_trace

BASE = 10 ** 18             # a hand-made base: the records' ns are BASE + seconds * 1e9
IDLE = ("draw_idle_share.train", "chunk_idle_share.render", "query_idle_share.render")
NAMES = {"draw_idle_share.train": "train.draw", "chunk_idle_share.render": "render.chunk",
         "query_idle_share.render": "query", "draw_ms_per_step.train": "train.draw"}


def _rec(name, s, e, n=None, parent=-1, index=0):
    from dmnerf_tpu_torch.utils.spans import Record

    return Record(name, BASE + round(s * 1e9), BASE + round(e * 1e9), parent,
                  index if parent == -1 else parent, n, index)


def _trace(device, t0=0.0, t1=10.0):
    return Trace(conf={}, kind="NVIDIA H100 80GB HBM3", work={}, roles={},
                 device=[("k", s, e) for s, e in device], host=[], t0=t0, t1=t1)


@pytest.fixture
def records(monkeypatch):
    """Hand the readers these records on the hand-made base."""
    box = []
    monkeypatch.setattr(bspans, "base_ns", lambda: BASE)
    monkeypatch.setattr(bspans, "program_records", lambda: list(box))
    return box


def _read(metric, t):
    return registry.reader("metrics", metric)(t)


# device busy [1, 2) and [4, 8): idle [0, 1), [2, 4), [8, 10) of a 10 s window
BUSY = [(1.0, 2.0), (4.0, 5.0), (5.0, 8.0)]


@pytest.mark.parametrize("metric", IDLE)
def test_a_gap_inside_the_span_counts_and_one_outside_does_not(records, metric):
    records.append(_rec(NAMES[metric], 1.5, 3.0, n=4))          # 1 s of the [2, 4) gap
    assert _read(metric, _trace(BUSY)) == pytest.approx(10.0)
    records.append(_rec(NAMES[metric], 4.0, 8.0, n=4, index=1))  # busy all through
    assert _read(metric, _trace(BUSY)) == pytest.approx(10.0)


@pytest.mark.parametrize("metric", IDLE)
def test_nested_spans_count_once(records, metric):
    name = NAMES[metric]
    records += [_rec(name, 0.0, 3.0, index=0), _rec(name, 0.5, 2.5, parent=0, index=1),
                _rec(name, 2.2, 2.4, parent=0, index=2)]
    assert _read(metric, _trace(BUSY)) == pytest.approx(20.0)   # [0, 1) and [2, 3)


@pytest.mark.parametrize("metric", IDLE)
def test_the_window_clips(records, metric):
    records += [_rec(NAMES[metric], -5.0, 0.5, index=0), _rec(NAMES[metric], 9.0, 12.0, index=1),
                _rec(NAMES[metric], 20.0, 30.0, index=2)]
    assert _read(metric, _trace(BUSY)) == pytest.approx(15.0)   # [0, 0.5) and [9, 10)
    assert _read(metric, _trace(BUSY, t0=0.25, t1=9.5)) == pytest.approx(100 * 0.75 / 9.25)


def test_the_render_chunks_of_both_renderers_count(records):
    records += [_rec("render.chunk", 0.0, 0.5, index=0), _rec("mani.chunk", 2.0, 2.5, index=1),
                _rec("query", 3.0, 4.0, index=2)]
    assert _read("chunk_idle_share.render", _trace(BUSY)) == pytest.approx(10.0)


def test_draw_ms_per_step(records):
    records += [_rec("train.draw", 0.0, 0.02, n=10, index=0),
                _rec("train.replay", 0.02, 0.2, n=10, index=1),
                _rec("train.draw", 0.3, 0.34, n=10, index=2),
                _rec("train.draw", 9.99, 10.01, n=10, index=3)]   # half in the window
    assert _read("draw_ms_per_step.train", _trace(BUSY)) == pytest.approx(70.0 / 25.0)


@pytest.mark.parametrize("metric", sorted(NAMES))
def test_none_without_records_or_without_the_program_module(records, metric, monkeypatch):
    assert _read(metric, _trace(BUSY)) is None
    records.append(_rec("train.replay", 0, 9))
    assert _read(metric, _trace(BUSY)) is None                  # none of its names
    records.append(_rec(NAMES[metric], 11.0, 12.0, n=1, index=1))
    assert _read(metric, _trace(BUSY)) is None                  # none in the window
    records.append(_rec(NAMES[metric], 0.0, 3.0, n=1, index=2))
    assert _read(metric, _trace(BUSY)) is not None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "dmnerf_tpu_torch.utils.spans", None)
    assert bspans.program_records() is None
    assert _read(metric, _trace(BUSY)) is None


def _span_report():
    """``scripts/span_report_torch.py`` as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "scripts" / "span_report_torch.py"
    spec = importlib.util.spec_from_file_location("span_report_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_idle_time_by_innermost_span_adds_up_to_the_idle_share(records):
    mod = _span_report()
    records += [_rec("mani.chunk", 0.0, 9.0, index=0),
                _rec("query", 0.5, 3.5, parent=0, index=1),
                _rec("query", 2.5, 3.0, parent=1, index=2)]
    split = mod.idle_by_innermost(_trace(BUSY))
    assert split == pytest.approx({"mani.chunk": 20.0, "query": 20.0, mod.OUTSIDE: 10.0})
    assert sum(split.values()) == pytest.approx(50.0)


def test_real_spans_land_on_the_exported_trace_clock(tmp_path):
    """A tiny view profiled on the CPU: each span of the program, put on the trace's clock
    by the helper's own base, holds operations of the trace, and none of them crosses its
    start or end by 1 ms or more."""
    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.render.renderer import make_image_renderer
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.utils import spans

    cfg = Config(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
                 N_samples=8, N_importance=8, N_test=32, near=2.0, far=7.0, ins_num=4)
    pc, pf = init_params(cfg, "cpu")
    o, d = torch.zeros((50, 3)), torch.nn.functional.normalize(torch.ones((50, 3)), dim=-1)
    render = make_image_renderer(cfg)
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        render(pc, pf, o, d)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    _, host, _ = read_chrome_trace(str(path))
    assert json.loads(path.read_text())["baseTimeNanoseconds"] == bspans.base_ns()
    t = Trace(conf={}, kind="cpu", work={}, roles={}, device=[], host=host,
              t0=min(s for _, s, _ in host), t1=max(e for _, _, e in host))
    mine = bspans.opened(t, None)
    assert [s.name for s in mine][:3] == ["render.chunk", "query", "query"]
    for span in mine:
        inside = [(s, e) for _, s, e in host if span.start <= s <= span.end]
        crossing = [e - span.end for s, e in inside] + [
            span.start - s for _, s, e in host if span.start <= e <= span.end]
        assert inside and max(crossing + [0.0]) < 1e-3, span.name


def test_the_span_report_script(records):
    """``scripts/span_report_torch.py``'s reading of a hand-made stretch: the idle split,
    the graph launches' misfit against the replay spans, the captures counted."""
    mod = _span_report()
    records += [_rec("train.draw", 0.0, 1.0, n=10, index=0),
                _rec("train.replay", 1.0, 1.5, n=10, index=1),
                _rec("train.draw", 20.0, 21.0, n=10, index=2)]
    host = [("cudaGraphLaunch", 1.1, 1.2), ("cudaGraphLaunch", 1.45, 1.5003),
            ("cudaLaunchKernel", 3.0, 3.1)]
    device = [("k", s, e) for s, e in BUSY]
    line = mod.report(([], device, host, (0.0, 10.0)), BASE)
    assert line["idle_share"] == pytest.approx(50.0)
    assert line["idle_by_span"] == pytest.approx({"train.draw": 10.0, mod.OUTSIDE: 40.0})
    assert line["spans"] == {"train.draw": 1, "train.replay": 1}
    assert line["graph_launches"] == 2 and line["captures"] == 0
    capture = [("cudaStreamBeginCapture_v10000", 5.0, 5.01), ("cudaGraphInstantiate", 5.1, 5.2)]
    assert mod.report(([], device, host + capture, (0.0, 10.0)), BASE)["captures"] == 2
    assert line["replay_misfit_us"] == pytest.approx(300.0)
    assert mod.misfit_s([(0.0, 1.0)], []) == float("inf")
