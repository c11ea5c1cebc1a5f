"""``steps_per_dispatch`` in the port (``train.make_packed_steps``, ``render.packing``) on
the CPU, where a pack runs its P steps eagerly from the buffers it drew ahead: packed
training equals the same steps one by one, bit for bit, with the full-image sampler and
with ScanNet's crop sampler; a pack's draw made ahead of the next call is used when it
still holds and thrown away otherwise, and packs between single steps (``pack_ok``'s
pattern) draw what the steps one by one draw, leaving the generators where they leave
them after every call; the effective pack size, its messages and the pack rule
(``pack_ok``) are the JAX package's (``dmnerf_tpu/train.py:94-125, 175-190``); debug_nans
inside a pack, the first or one drawn ahead, names the first bad step; train() with
packing logs the iterations the JAX train() logs, within the training-parity bars; a
checkpoint of a packed run resumes unpacked.

Tolerances: packed against unpacked, exact; the port's train() against JAX's, 0.1 dB of
PSNR and 2 % of the total loss at every logged iteration (tests/test_training_parity.py:
43-62), on a scene where every step sees every pixel of the one train view, so the two
packages' different random draws give the same batches up to their order.
"""

import ast
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from dmnerf_tpu import train as jtrain  # noqa: E402
from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.data.scene import SceneData as JSceneData  # noqa: E402
from dmnerf_tpu.render import trainstep as jts  # noqa: E402
from dmnerf_tpu_torch import train as ttrain  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.data import synthetic as tsyn  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.render.packing import StepRunner  # noqa: E402
from dmnerf_tpu_torch.render.trainstep import create_train_state, make_train_step  # noqa: E402
from dmnerf_tpu_torch.test import init_params  # noqa: E402
from dmnerf_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
            N_samples=8, N_importance=8, N_train=64, N_test=128, near=2.0, far=7.0,
            lrate=5e-3, lrate_decay=500, perturb=1.0, penalize=True, tolerance=0.05,
            deta_w=0.05)


@pytest.fixture(scope="module")
def scenes():
    full = tsyn.build_dmsr_scene(n_train=4, n_test=1, H=16, W=16, n_objects=3, ins_num=8, seed=0)
    crop = tsyn.build_scannet_scene(Config(crop_width=16, crop_height=12, weakly_value=1.0),
                                    n_train=3, n_test=1, H=16, W=20, n_objects=3, seed=0)
    return {"full": full, "crop": crop}


def _start(cfg):
    """train()'s start on the CPU: its seeded parameters and generators."""
    return (create_train_state(cfg, *init_params(cfg, "cpu")),
            torch.Generator().manual_seed(cfg.seed + 1), torch.Generator().manual_seed(cfg.seed + 2))


def _same_state(a, b) -> bool:
    pairs = [(a.params_coarse, b.params_coarse), (a.params_fine, b.params_fine)]
    for pa, pb in pairs:
        for k in pa:
            sa, sb = a.opt.state[pa[k]], b.opt.state[pb[k]]
            if not torch.equal(pa[k], pb[k]) or sa.keys() != sb.keys() \
                    or not all(torch.equal(sa[m], sb[m]) for m in sa):
                return False
    return a.step == b.step


def _rows(auxs):
    return torch.stack(list(auxs.values()), -1).clone()


def _gen_states(gb, gs):
    return [gb.get_state(), gs.get_state()]


@pytest.mark.parametrize("kind", ["full", "crop"])
def test_packed_steps_equal_the_steps_one_by_one(scenes, kind):
    """Three packs of 4 against 12 steps one by one from the same runner buffers, and
    against the step function fed by the sampler and the generator directly (the draws
    inside render_rays): parameters, Adam's state and every aux, bit for bit; each pack
    after the first runs from the draw the one before it made ahead."""
    scene = scenes[kind]
    cfg = Config(**TINY, ins_num=scene.ins_num, steps_per_dispatch=4, i_print=4)
    sampler, n_ins = ttrain.make_sampler(cfg, scene, "cpu")
    assert (n_ins is None) == (kind == "full")

    st_d, gb, gs = _start(cfg)
    step = make_train_step(cfg, N_ins=n_ins)
    direct = torch.stack([torch.stack(list(step(st_d, sampler(gb), generator=gs).values()))
                          for _ in range(12)])
    st_u, gb, gs = _start(cfg)
    single = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), "cpu", 1)
    one_by_one = torch.cat([_rows(single(st_u, gb, gs)) for _ in range(12)])
    want_gens = _gen_states(gb, gs)
    st_p, gb, gs = _start(cfg)
    runtime.reset_launches()
    packed, P = ttrain.make_packed_steps(cfg, sampler, n_ins, "cpu")
    assert P == 4
    packs = torch.cat([_rows(packed(st_p, gb, gs)) for _ in range(3)])
    assert not any(runtime.LAUNCHES.values())
    assert torch.equal(direct, one_by_one) and torch.equal(one_by_one, packs)
    assert torch.isfinite(packs).all()
    assert _same_state(st_d, st_u) and _same_state(st_u, st_p) and st_p.step == 12
    assert packed.ahead == {"used": 2, "discarded": 0}
    assert all(torch.equal(a, b) for a, b in zip(_gen_states(gb, gs), want_gens))
    assert single.ahead == {"used": 0, "discarded": 0} and single.pending is None


@pytest.mark.parametrize("kind", ["full", "crop"])
@pytest.mark.parametrize("i_save", [6, 9])
def test_packs_between_single_steps_draw_what_the_steps_one_by_one_draw(scenes, kind, i_save):
    """train()'s pattern over 16 steps in packs of 4 with a checkpoint every i_save
    steps (``pack_ok``): the packed runner and the one-step runner take turns on the
    same generators. Every aux and the final state equal 16 steps one by one, bit for
    bit, and after every call both generators' states equal the one-by-one run's after
    as many steps. A pack right after a pack uses the draw made ahead; a pack after
    single steps throws it away."""
    scene = scenes[kind]
    cfg = Config(**TINY, ins_num=scene.ins_num, steps_per_dispatch=4, i_print=4, N_iters=16,
                 i_save=i_save, i_test=10 ** 6)
    sampler, n_ins = ttrain.make_sampler(cfg, scene, "cpu")

    st_u, gb, gs = _start(cfg)
    single = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), "cpu", 1)
    rows, gens = [], [_gen_states(gb, gs)]
    for _ in range(cfg.N_iters):
        rows.append(_rows(single(st_u, gb, gs)))
        gens.append(_gen_states(gb, gs))

    st, gb, gs = _start(cfg)
    single = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), "cpu", 1)
    packed, P = ttrain.make_packed_steps(cfg, sampler, n_ins, "cpu")
    got, kinds, i = [], [], 0
    while i < cfg.N_iters:
        pack = ttrain.pack_ok(cfg, i, P, True)
        got.append(_rows((packed if pack else single)(st, gb, gs)))
        kinds.append(pack)
        i += P if pack else 1
        assert st.step == i
        assert all(torch.equal(a, b) for a, b in zip(_gen_states(gb, gs), gens[i])), i
    assert True in kinds and False in kinds
    assert torch.equal(torch.cat(got), torch.cat(rows))
    assert _same_state(st, st_u)
    first = kinds.index(True)
    used = sum(1 for k in range(first + 1, len(kinds)) if kinds[k] and kinds[k - 1])
    discarded = sum(1 for k in range(first + 1, len(kinds)) if kinds[k] and not kinds[k - 1])
    assert packed.ahead == {"used": used, "discarded": discarded}
    assert discarded >= 1


def _disturb(how, state, gb, gs):
    """Something between two packed calls; returns the generators the next call takes."""
    if how == "gen_batch drew":
        torch.rand(3, generator=gb)
    elif how == "gen_step drew":
        torch.rand(3, generator=gs)
    elif how == "state.step moved":
        state.step += 1
    elif how == "other generators":     # copies, in the same states
        copies = torch.Generator(), torch.Generator()
        for c, g in zip(copies, (gb, gs)):
            c.set_state(g.get_state())
        gb, gs = copies
    return gb, gs


@pytest.mark.parametrize("how", ["nothing", "gen_batch drew", "gen_step drew",
                                 "state.step moved", "other generators"])
def test_a_draw_ahead_is_used_only_while_it_holds(scenes, how):
    """Two packed calls with ``how`` between them, against the same two calls where the
    second is a fresh runner's, which has drawn nothing ahead: the second pack's auxs,
    the state and the generators' states after it, bit for bit. Anything that changes
    what the next pack would draw throws the draw ahead away."""
    cfg = Config(**TINY, ins_num=8, steps_per_dispatch=4, i_print=4)
    sampler, _ = ttrain.make_sampler(cfg, scenes["full"], "cpu")
    runs = []
    for fresh in (False, True):
        state, gb, gs = _start(cfg)
        packed, _ = ttrain.make_packed_steps(cfg, sampler, None, "cpu")
        packed(state, gb, gs)
        assert packed.pending is not None
        gb, gs = _disturb(how, state, gb, gs)
        runner = ttrain.make_packed_steps(cfg, sampler, None, "cpu")[0] if fresh else packed
        runs.append((_rows(runner(state, gb, gs)), state, _gen_states(gb, gs), packed.ahead))
    (rows, state, gens, ahead), (want_rows, want_state, want_gens, _) = runs
    assert torch.equal(rows, want_rows) and _same_state(state, want_state)
    assert all(torch.equal(a, b) for a, b in zip(gens, want_gens))
    held = how == "nothing"
    assert ahead == {"used": int(held), "discarded": int(not held)}


class _FailsOnce:
    """The sampler, but its draw number ``at`` (from 0) raises."""

    def __init__(self, sampler, at: int):
        self.sampler, self.at, self.n = sampler, at, 0

    def draw(self, gen):
        self.n += 1
        if self.n == self.at + 1:
            raise RuntimeError("the sampler failed")
        return self.sampler.draw(gen)

    def __getattr__(self, name):
        return getattr(self.sampler, name)


@pytest.mark.parametrize("at", [4, 6])
def test_a_draw_ahead_that_raises_leaves_the_generators_as_it_found_them(scenes, at):
    """The first pack's draw ahead raises at its first or a later step: the pack has run,
    the generators are where a pack leaves them, nothing is held for the next call, and
    the next call draws the second pack as a runner whose sampler never failed, bit for
    bit."""
    cfg = Config(**TINY, ins_num=8, steps_per_dispatch=4, i_print=4)
    sampler, _ = ttrain.make_sampler(cfg, scenes["full"], "cpu")
    want_state, gb, gs = _start(cfg)
    clean, _ = ttrain.make_packed_steps(cfg, sampler, None, "cpu")
    clean(want_state, gb, gs)
    want_gens = _gen_states(gb, gs)
    want_rows = _rows(clean(want_state, gb, gs))

    state, gb, gs = _start(cfg)
    failing, _ = ttrain.make_packed_steps(cfg, _FailsOnce(sampler, at), None, "cpu")
    with pytest.raises(RuntimeError, match="the sampler failed"):
        failing(state, gb, gs)
    assert state.step == 4 and failing.pending is None
    assert all(torch.equal(a, b) for a, b in zip(_gen_states(gb, gs), want_gens))
    assert torch.equal(_rows(failing(state, gb, gs)), want_rows)
    assert _same_state(state, want_state)
    assert failing.ahead == {"used": 0, "discarded": 0}


@pytest.mark.parametrize("spd, i_print", [(4, 4), (4, 6), (10, 100), (3, 4), (1, 7), (6, 1)])
def test_pack_size_and_messages_match_jax(scenes, spd, i_print):
    cfg = dict(TINY, ins_num=8, steps_per_dispatch=spd, i_print=i_print)
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        jres = jtrain.make_packed_steps(JConfig(**cfg), None, None)
    sampler, _ = ttrain.make_sampler(Config(**cfg), scenes["full"], "cpu")
    with contextlib.redirect_stdout(tout):
        tres = ttrain.make_packed_steps(Config(**cfg), sampler, None, "cpu")
    assert tout.getvalue() == jout.getvalue()
    assert (tres is None) == (jres is None)
    if tres is not None:
        assert tres[1] == jres[1]


def _jax_pack_ok(cfg, P, has_test_views):
    """The pack rule of the JAX train(): its nested ``pack_ok``, taken from the source."""
    src = open(os.path.join(REPO, "dmnerf_tpu", "train.py")).read()
    train_fn = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)
                    and n.name == "train")
    fn = next(n for n in ast.walk(train_fn) if isinstance(n, ast.FunctionDef)
              and n.name == "pack_ok")
    ns = {"cfg": cfg, "P": P, "has_test_views": has_test_views}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "dmnerf_tpu/train.py", "exec"), ns)
    return ns["pack_ok"]


PACK_CASES = [  # (N_iters, i_save, i_test, profile_dir, has test views, P)
    (40, 10 ** 6, 10 ** 6, None, True, 4),
    (42, 10, 10 ** 6, None, True, 4),
    (40, 10 ** 6, 6, None, True, 4),
    (40, 10 ** 6, 6, None, False, 4),
    (40, 7, 9, None, True, 2),
    (23, 10 ** 6, 10 ** 6, None, False, 5),
    (40, 10 ** 6, 10 ** 6, "prof", True, 4),
    (12, 4, 4, None, True, 4),
]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_ok_matches_jax(case):
    n_iters, i_save, i_test, profile_dir, has_test, P = case
    kw = dict(TINY, ins_num=8, N_iters=n_iters, i_save=i_save, i_test=i_test,
              profile_dir=profile_dir)
    jok = _jax_pack_ok(JConfig(**kw), P, has_test)
    cfg = Config(**kw)
    got = [ttrain.pack_ok(cfg, i, P, has_test) for i in range(n_iters + P)]
    assert got == [bool(jok(i)) for i in range(n_iters + P)]


@pytest.mark.parametrize("pack", [0, 1])
def test_debug_nans_in_a_pack_names_the_first_bad_step(scenes, pack):
    """One train image of NaN, first drawn by a later step of pack ``pack`` (the second
    pack runs from the draw the first made ahead): that step has a NaN rgb loss, and the
    pack raises FloatingPointError naming it (the steps before it are fine)."""
    cfg = Config(**TINY, ins_num=8, steps_per_dispatch=4, i_print=4, debug_nans=True)
    sampler, _ = ttrain.make_sampler(cfg, scenes["full"], "cpu")
    for seed in range(100):      # a seed whose draws first meet an image there
        g = torch.Generator().manual_seed(seed + 1)
        drawn = [int(sampler.draw(g)[0]) for _ in range(4 * (pack + 1))]
        firsts = [k for k, img in enumerate(drawn) if img not in drawn[:k]]
        if firsts[-1] > 4 * pack:
            break
    else:
        pytest.fail("no seed first draws an image late in the pack")
    first = firsts[-1]
    cfg = cfg.replace(seed=seed)
    scene = dataclasses.replace(scenes["full"], images=scenes["full"].images.copy())
    scene.images[drawn[first]] = np.nan
    sampler, _ = ttrain.make_sampler(cfg, scene, "cpu")
    state, gb, gs = _start(cfg)
    packed, _ = ttrain.make_packed_steps(cfg, sampler, None, "cpu")
    for _ in range(pack):
        packed(state, gb, gs)
    with pytest.raises(FloatingPointError, match=rf"debug_nans: step {first}: non-finite loss rgb_loss"):
        packed(state, gb, gs)
    assert packed.ahead == {"used": pack, "discarded": 0}


def _jax_state_params(jcfg):
    """The JAX train()'s initial parameters: its key split (dmnerf_tpu/train.py:150-152)."""
    key = jax.random.PRNGKey(jcfg.seed)
    _, init_key = jax.random.split(key)
    st = jts.create_train_state(jcfg, init_key)
    to_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731
    return to_np(st.params_coarse), to_np(st.params_fine)


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_packed_train_logs_like_the_jax_train(tmp_path):
    """train() with steps_per_dispatch 2, i_print 2 and a checkpoint boundary at 5 in both
    packages, from the same parameters: the same logged iterations and checkpoints (the
    pack holding 5 runs as single steps), the losses within the parity bars. One train
    view of 7 x 9 and N_train 63: every step's batch is all of its pixels (63 rays are
    no multiple of the 8 virtual CPU devices of tests/conftest.py, so JAX trains on one)."""
    scene = tsyn.build_dmsr_scene(n_train=1, n_test=1, H=7, W=9, n_objects=2, ins_num=4, seed=0)
    kw = dict(TINY, ins_num=scene.ins_num, N_train=63, perturb=0.0, N_iters=10, i_print=2, i_save=5,
              i_test=10 ** 6, steps_per_dispatch=2, expname="packed")
    jcfg = JConfig(**kw, basedir=str(tmp_path / "jax"))
    jtrain.train(jcfg, JSceneData(**dataclasses.asdict(scene)))
    cfg = Config(**kw, basedir=str(tmp_path / "port"))
    pc, pf = _jax_state_params(jcfg)
    save_checkpoint(cfg.log_dir, params_from_numpy(pc, "cpu"), params_from_numpy(pf, "cpu"), 0)
    state = ttrain.train(cfg, scene, device="cpu")
    assert state.step == 10
    ours, ref = _records(cfg.log_dir), _records(jcfg.log_dir)
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [0, 2, 4, 6, 8]
    for o, r in zip(ours, ref):
        assert abs(o["psnr_fine"] - r["psnr_fine"]) <= 0.1, (o["step"], o, r)
        assert abs(o["total_loss"] - r["total_loss"]) <= 0.02 * max(abs(r["total_loss"]), 1.0)
    ckpts = sorted(os.listdir(os.path.join(cfg.log_dir, "checkpoints")))
    assert ckpts == ["000000.pt", "000006.pt", "000010.pt"]
    assert sorted(os.listdir(os.path.join(jcfg.log_dir, "checkpoints"))) == ["000006", "000010"]


def test_a_packed_run_equals_the_unpacked_run_and_resumes_unpacked(scenes, tmp_path):
    """train() in packs of 4 ends where train() one step at a time ends, bit for bit; its
    checkpoint resumes without packing, as the same two steps from that checkpoint."""
    scene = scenes["full"]
    kw = dict(TINY, ins_num=8, N_iters=8, i_print=4, i_save=10 ** 6, i_test=10 ** 6)
    packed = ttrain.train(Config(**kw, basedir=str(tmp_path / "p"), steps_per_dispatch=4),
                          scene, device="cpu")
    unpacked = ttrain.train(Config(**kw, basedir=str(tmp_path / "u")), scene, device="cpu")
    assert _same_state(packed, unpacked)

    cfg = Config(**dict(kw, N_iters=10, i_print=1), basedir=str(tmp_path / "p"))
    pc, pf, step, opt = restore_checkpoint(cfg.log_dir, "cpu")
    assert step == 8 and int(opt["state"][0]["step"]) == 8
    resumed = ttrain.train(cfg, scene, device="cpu")
    assert [r["step"] for r in _records(cfg.log_dir)] == [0, 4, 8, 9]

    want = create_train_state(cfg, pc, pf, step)
    want.opt.load_state_dict(opt)
    sampler, _ = ttrain.make_sampler(cfg, scene, "cpu")
    single = StepRunner(cfg, sampler, make_train_step(cfg), "cpu", 1)
    gb, gs = torch.Generator().manual_seed(cfg.seed + 1), torch.Generator().manual_seed(cfg.seed + 2)
    for _ in range(2):
        single(want, gb, gs)
    assert _same_state(resumed, want)


def test_adam_state_restores_across_forms(scenes):
    """A checkpoint's Adam state in the card's form (capturable, a learning-rate tensor)
    restores into the CPU's Adam in the CPU's form, and the next step is the step of the
    same state saved on the CPU."""
    import copy

    from dmnerf_tpu_torch.render.trainstep import load_adam_state

    cfg = Config(**TINY, ins_num=8)
    sampler, _ = ttrain.make_sampler(cfg, scenes["full"], "cpu")
    state, gb, gs = _start(cfg)
    step = make_train_step(cfg)
    step(state, sampler(gb), generator=gs)
    saved = state.opt.state_dict()
    card = {"state": saved["state"],
            "param_groups": [dict(g, capturable=True, lr=torch.tensor(0.125)) for g in
                             saved["param_groups"]]}
    runs = []
    for opt_state in (saved, card):
        st = create_train_state(cfg, state.params_coarse, state.params_fine, state.step)
        load_adam_state(st.opt, copy.deepcopy(opt_state))   # state_dict() aliases the moments
        group = st.opt.param_groups[0]
        assert not group["capturable"] and isinstance(group["lr"], float)
        step(st, sampler(torch.Generator().manual_seed(5)), generator=torch.Generator().manual_seed(6))
        runs.append(st)
    assert _same_state(*runs)
