"""The port's spans (``dmnerf_tpu_torch.utils.spans``) on the CPU: nothing is recorded and
no object is made while no profiler runs; under a CPU ``torch.profiler`` the train
runner, the image renderer and the manipulator record their spans, nested as the module
says, each holding its own operations of the exported trace within 1 ms once
``baseTimeNanoseconds`` is added; a ``profile_dir`` trace carries them as events; and the
renderers' outputs are bit-equal with and without a profiler running."""

import json

import pytest

torch = pytest.importorskip("torch")

from dmnerf_tpu_torch import train as ttrain  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.data import synthetic as tsyn  # noqa: E402
from dmnerf_tpu_torch.render.manipulator import make_manipulator_renderer  # noqa: E402
from dmnerf_tpu_torch.render.packing import StepRunner  # noqa: E402
from dmnerf_tpu_torch.render.renderer import make_image_renderer  # noqa: E402
from dmnerf_tpu_torch.render.trainstep import create_train_state, make_train_step  # noqa: E402
from dmnerf_tpu_torch.test import init_params  # noqa: E402
from dmnerf_tpu_torch.utils import spans  # noqa: E402

torch.set_num_threads(2)
TINY = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
            N_samples=8, N_importance=8, N_train=64, N_test=48, near=2.0, far=7.0,
            lrate=5e-3, lrate_decay=500, perturb=1.0, penalize=True, tolerance=0.05,
            deta_w=0.05, ins_num=8)
RAYS = 100          # 3 chunks of 48, the last holding 4 real rays


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _rays(seed, n=RAYS):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g) * 0.1
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return o, d


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.index]


def _check_units(recs):
    by_index = {r.index: r for r in recs}
    for r in recs:
        if r.parent == -1:
            assert r.unit == r.index
        else:
            assert r.unit == by_index[r.parent].unit
            assert by_index[r.parent].start_ns <= r.start_ns <= r.end_ns \
                <= by_index[r.parent].end_ns


def test_without_a_profiler_a_span_records_nothing_and_is_one_object():
    spans.clear()
    a, b = spans.span("render.chunk", 3), spans.span("query")
    assert a is b
    with a, spans.span("train.draw", 2):
        pass
    assert spans.records() == []


@pytest.mark.parametrize("P", [1, 2])
def test_the_runner_records_its_draw_then_its_eager_steps(P):
    scene = tsyn.build_dmsr_scene(n_train=2, n_test=1, H=12, W=12, n_objects=3, ins_num=8,
                                  seed=0)
    cfg = Config(**TINY)
    sampler, n_ins = ttrain.make_sampler(cfg, scene, "cpu")
    runner = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), "cpu", P)
    state = create_train_state(cfg, *init_params(cfg, "cpu"))
    gb, gs = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    spans.clear()
    with _profile():
        for _ in range(2):
            runner(state, gb, gs)
    recs = spans.records()
    _check_units(recs)
    top = [r for r in recs if r.parent == -1]
    # a pack of P > 1 draws the next pack ahead after it runs, and the next call uses it
    units = 2 * ["train.draw", "train.eager"] + (["train.draw"] if P > 1 else [])
    assert [(r.name, r.n) for r in top] == [(name, P) for name in units]
    for before, after in zip(top, top[1:]):
        assert before.end_ns <= after.start_ns
    for unit in top:
        if unit.name == "train.draw":
            assert not _children(recs, unit)
        else:   # a step's coarse and fine queries (the fused query's plain versions on the CPU)
            assert [(r.name, r.n) for r in _children(recs, unit)] == P * [
                ("query", 64 * 8), ("query", 64 * 16)]


def test_a_view_records_its_chunks_each_with_its_two_queries():
    cfg = Config(**TINY)
    pc, pf = init_params(cfg, "cpu")
    render = make_image_renderer(cfg)
    o, d = _rays(3)
    spans.clear()
    with _profile():
        render(pc, pf, o, d)
    recs = spans.records()
    _check_units(recs)
    chunks = [r for r in recs if r.parent == -1]
    assert [(r.name, r.n) for r in chunks] == [("render.chunk", 48), ("render.chunk", 48),
                                               ("render.chunk", 4)]
    for c in chunks:
        assert [(r.name, r.n) for r in _children(recs, c)] == [("query", 48 * 8),
                                                                ("query", 48 * 16)]
    assert len(recs) == 3 * 3


def test_a_manipulated_view_records_its_chunks_each_with_six_queries():
    cfg = Config(**TINY)
    pc, pf = init_params(cfg, "cpu")
    run = make_manipulator_renderer(cfg, 1)
    (o, d), (to, td) = _rays(4), _rays(5)
    spans.clear()
    with _profile():
        run(pc, pf, o, d, to[None], td[None], (2,), generator=torch.Generator().manual_seed(6))
    recs = spans.records()
    _check_units(recs)
    chunks = [r for r in recs if r.parent == -1]
    assert [(r.name, r.n) for r in chunks] == [("mani.chunk", 48), ("mani.chunk", 48),
                                               ("mani.chunk", 4)]
    for c in chunks:
        # pass 1: the original and the target bundle, coarse then fine; pass 2: both fine
        # on the union of their samples
        assert [(r.name, r.n) for r in _children(recs, c)] == [
            ("query", 48 * 8), ("query", 48 * 16), ("query", 48 * 8), ("query", 48 * 16),
            ("query", 48 * 24), ("query", 48 * 24)]
    assert len(recs) == 3 * 7


def _run_one(kind):
    """One call of ``kind`` (a P = 2 runner, a view, a manipulated view) at the tiny size."""
    cfg = Config(**TINY)
    pc, pf = init_params(cfg, "cpu")
    o, d = _rays(7)
    if kind == "train":
        scene = tsyn.build_dmsr_scene(n_train=2, n_test=1, H=12, W=12, n_objects=3, ins_num=8,
                                      seed=0)
        sampler, n_ins = ttrain.make_sampler(cfg, scene, "cpu")
        runner = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), "cpu", 2)
        state = create_train_state(cfg, pc, pf)
        gb, gs = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
        return lambda: runner(state, gb, gs)
    if kind == "view":
        render = make_image_renderer(cfg)
        return lambda: render(pc, pf, o, d)
    run = make_manipulator_renderer(cfg, 1)
    to, td = _rays(8)
    return lambda: run(pc, pf, o, d, to[None], td[None], (2,),
                       generator=torch.Generator().manual_seed(9))


def _straddling_ms(rec, ops, base):
    """How far the trace's operations that start (end) inside a record on its clock end
    after (start before) it, in ms; and how many start inside it."""
    s, e = (rec.start_ns - base) * 1e-3, (rec.end_ns - base) * 1e-3      # µs, as ``ts``
    inside = [(a, b) for a, b in ops if s <= a <= e]
    worst = max([b - e for a, b in inside] + [s - a for a, b in ops if s <= b <= e] + [0.0])
    return worst * 1e-3, len(inside)


@pytest.mark.parametrize("kind", ["train", "view", "mani"])
def test_records_hold_their_operations_on_the_exported_trace_clock(tmp_path, kind):
    """Put on the trace's clock by ``baseTimeNanoseconds``, every span holds operations of
    the trace, and none of them crosses its start or end by 1 ms or more."""
    call = _run_one(kind)
    spans.clear()
    with _profile() as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    ops = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])) for ev in trace["traceEvents"]
           if ev.get("ph") == "X" and ev.get("cat") == "cpu_op"]
    recs = spans.records()
    assert recs
    for r in recs:
        worst_ms, n_inside = _straddling_ms(r, ops, base)
        assert n_inside > 0 and worst_ms < 1.0, (r.name, worst_ms, n_inside)


def test_a_profile_dir_trace_carries_the_spans(tmp_path):
    """``train.profile_trace`` and the trace it writes: the spans of the profiled steps
    as ``user_annotation`` events, where the records put them."""
    scene = tsyn.build_dmsr_scene(n_train=2, n_test=1, H=12, W=12, n_objects=3, ins_num=8,
                                  seed=0)
    cfg = Config(**TINY, profile_dir=str(tmp_path))
    sampler, n_ins = ttrain.make_sampler(cfg, scene, "cpu")
    runner = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), "cpu", 1)
    state = create_train_state(cfg, *init_params(cfg, "cpu"))
    gb, gs = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    with spans.span("train.draw"):
        pass                                    # no profiler: nothing to write
    prof = ttrain.profile_trace(torch.device("cpu"))
    for _ in range(2):
        runner(state, gb, gs)
    recs = spans.records()
    path = ttrain._write_trace(prof, cfg, torch.device("cpu"), 0, 1)
    assert spans.records() == []
    trace = json.loads(open(path).read())
    base = int(trace["baseTimeNanoseconds"])
    names = {r.name for r in recs}
    events = [ev for ev in trace["traceEvents"]
              if ev.get("cat") == "user_annotation" and ev["name"] in names]
    assert [(ev["name"], ev["args"]["n"]) for ev in events] == [(r.name, r.n) for r in recs]
    assert [r.name for r in recs if r.parent == -1] == 2 * ["train.draw", "train.eager"]
    for ev, r in zip(events, recs):
        assert ev["ts"] == pytest.approx((r.start_ns - base) / 1e3)
        assert ev["dur"] == pytest.approx((r.end_ns - r.start_ns) / 1e3)


def test_outputs_are_bit_equal_with_and_without_a_profiler():
    cfg = Config(**TINY)
    pc, pf = init_params(cfg, "cpu")
    render, mani = make_image_renderer(cfg), make_manipulator_renderer(cfg, 1)
    (o, d), (to, td) = _rays(8), _rays(9)

    def both():
        view = render(pc, pf, o, d)
        edited = mani(pc, pf, o, d, to[None], td[None], (2,),
                      generator=torch.Generator().manual_seed(10))
        return {**{f"view {k}": v for k, v in view.items()},
                **{f"mani {k}": v for k, v in edited.items()}}

    plain = both()
    spans.clear()
    with _profile():
        profiled = both()
    assert len(spans.records()) > 0
    assert plain.keys() == profiled.keys()
    for k in plain:
        assert torch.equal(plain[k], profiled[k]), k
