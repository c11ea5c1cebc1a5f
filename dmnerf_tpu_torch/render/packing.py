"""Train steps run from draws made ahead: one at a time, or P whole steps in one
dispatch (``steps_per_dispatch``, the JAX package's ``make_packed_steps``,
``dmnerf_tpu/train.py:94-125``).

``StepRunner(cfg, sampler, step_fn, device, P)`` (``step_fn`` from
``render.trainstep.make_train_step``) draws the inputs of its next P steps on
the host from the same generators, in the same order, as P steps one by one would: per
step the sampler's ids (``sample.draw``: the image and pixel ids, or ScanNet's slot,
labelled slots and rgb ids) from ``gen_batch``, then the uniforms ``u_z`` [N, N_samples]
and ``u_pdf`` [N, N_importance] from ``gen_step``, and the learning rate of the step.
The ids and the rates go to the device in one pinned host-to-device copy into static
buffers; the uniforms are drawn straight into theirs on the device. Each step then runs
from its slot (``sample.gather``, ``render_rays``, the losses with K11, autograd's
backward, Adam), so the trajectory is the one by one trajectory, bit for bit.

On the card, a runner of P > 1 steps captures the P steps once into one CUDA graph and
replays it for every pack: one ``cudaGraphLaunch`` a pack. Before the capture it runs two
steps eagerly on its capture stream (builds, Adam's state, the autograd engine, cuBLAS's
workspace for that stream), then puts the parameters, Adam's state and the step count
back as they were. The graph holds the addresses of the parameters, of Adam's state and
of its own allocations, which its private memory pool keeps for every replay (so the
kernels' tensor maps and host tables, taken by value at capture, stay true); a state
whose tensors are others is captured anew. A failed capture or replay raises. A runner
of one step, and every runner on the CPU, runs its steps eagerly from the same buffers.

Each step's aux goes into a static [P, len(aux)] buffer; with ``debug_nans`` each step of a
pack writes its finiteness checks into device flags that are read after the pack,
which raises FloatingPointError naming the first bad step (a one-step runner raises
before the update, as ``render.trainstep.check_finite`` does).

A call of a runner of P > 1 steps takes its inputs from a draw it made ahead, or draws
them, then replays (or runs), then draws the next pack ahead while the replay runs:

1. use or redraw: the draw made ahead at the end of the last call holds when the same two
   generators are passed, their ``get_state()`` equal the states saved just before that
   draw, and ``state.step`` is the step it was made for; the generators are then set to
   the states that draw left them in, and the static buffers are used as they are.
   Otherwise the pack draws now, and a draw ahead it throws away is counted;
2. capture if the state's addresses changed, then replay (or run the eager pack);
3. draw ahead: right after the replay's launch and before any host read (the
   ``debug_nans`` flags are read after it), the generators' states are saved, the next
   P steps are drawn into the same static buffers, the states after the draw are saved,
   and the generators are put back as they were (also when the draw raises: then nothing
   is held for the next call). So whoever draws from them next (the one-step runner at a
   pack boundary, another caller) sees no draw that no step used, and every interleaving
   draws the parent's ids, uniforms and rates bit for bit. The draw's uniforms and its
   pinned copy are queued on the current stream behind the replay that reads the
   buffers, and the pinned buffer is written only after the last copy out of it has
   ended (``copied``), so a draw never overwrites the inputs of the pack that runs.

``ahead`` counts the draws ahead ``used`` and ``discarded``. A runner of one step draws at
call time: its eager step keeps the host busy launching, so there is nothing to overlap.

Under a profiler a call records the spans ``train.draw`` (the host draws and the copy:
at the call's start when it draws then, and around the draw ahead), ``train.replay`` on
the card or ``train.eager`` otherwise (``utils.spans``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.render.trainstep import (
    TrainState, check_names, lr_at_step, raise_non_finite)
from dmnerf_tpu_torch.utils.device import capture_graph
from dmnerf_tpu_torch.utils.spans import span

WARMUP_STEPS = 2


class StepRunner:
    """``runner(state, gen_batch, gen_step)`` runs the next P train steps of ``state``
    from inputs it draws ahead (see the module docstring)."""

    def __init__(self, cfg: Config, sampler, step_fn, device, P: int):
        self.cfg, self.sampler, self.step_fn, self.P = cfg, sampler, step_fn, P
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        N = cfg.N_train
        self.n_ids = 1 + N
        ids_bytes = P * self.n_ids * 8
        nbytes = ids_bytes + 8 * -(-P * 4 // 8)
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cuda)
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device) if self.cuda \
            else self.host
        self.host_ids, self.host_lr = self._views(self.host, ids_bytes)
        self.ids, self.lr = self._views(self.dev, ids_bytes)
        self.perturb = cfg.perturb > 0.0
        self.u_z = self.u_pdf = None
        if self.perturb:
            self.u_z = torch.empty((P, N, cfg.N_samples), device=self.device)
            self.u_pdf = torch.empty((P, N, cfg.N_importance), device=self.device)
        self.copied = None          # the event after the last host-to-device copy
        self.pending = None         # the draw ahead: (generators, step, states before, after)
        self.ahead = {"used": 0, "discarded": 0}
        self.keys: Optional[List[str]] = None
        self.auxs: Optional[torch.Tensor] = None
        self.finite: Optional[torch.Tensor] = None
        self.graph = None
        self.graph_state = None     # the addresses the graph holds
        self.stream = None

    def _views(self, buf: torch.Tensor, ids_bytes: int):
        ids = buf[:ids_bytes].view(torch.int64).view(self.P, self.n_ids)
        return ids, buf[ids_bytes:ids_bytes + 4 * self.P].view(torch.float32)

    def draw(self, step: int, gen_batch: torch.Generator, gen_step: torch.Generator) -> None:
        """The inputs of steps step ... step + P - 1 into the static buffers."""
        if self.copied is not None:
            self.copied.synchronize()       # the last copy has left the pinned buffer
        for k in range(self.P):
            self.host_ids[k] = self.sampler.draw(gen_batch)
            self.host_lr[k] = lr_at_step(self.cfg, step + k)
            if self.perturb:
                torch.rand(self.u_z.shape[1:], generator=gen_step, out=self.u_z[k])
                torch.rand(self.u_pdf.shape[1:], generator=gen_step, out=self.u_pdf[k])
        if self.cuda:
            self.dev.copy_(self.host, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()

    def _step(self, state: TrainState, k: int, flags: bool) -> None:
        """Step k of the pack from its slot; its aux into row k of ``auxs``."""
        aux = self.step_fn(state, self.sampler.gather(self.ids[k]),
                           u_z=self.u_z[k] if self.perturb else None,
                           u_pdf=self.u_pdf[k] if self.perturb else None,
                           lr=self.lr[k] if self.cuda else None,
                           finite=self.finite[k] if flags else None)
        if self.keys is None:
            self.keys = list(aux)
            self.auxs = torch.empty((self.P, len(aux)), dtype=torch.float32, device=self.device)
        self.auxs[k].copy_(torch.stack([aux[key] for key in self.keys]))

    def _run(self, state: TrainState, steps) -> None:
        flags = self.cfg.debug_nans and self.P > 1
        if flags and self.finite is None:
            # one flag a loss component and a parameter (every parameter gets a gradient)
            self.finite = torch.ones((self.P, 4 + len(_params(state))), dtype=torch.bool,
                                     device=self.device)
        for k in steps:
            self._step(state, k, flags)

    def __call__(self, state: TrainState, gen_batch: torch.Generator,
                 gen_step: torch.Generator) -> Dict[str, torch.Tensor]:
        """P train steps of ``state`` (updated in place, ``state.step`` advanced by P);
        returns each aux as a [P] device tensor, a view of the static buffer that the
        next call overwrites."""
        step0 = state.step
        gens = (gen_batch, gen_step)
        if not self._take_ahead(step0, gens):
            with span("train.draw", self.P):
                self.draw(step0, gen_batch, gen_step)
        if self.cuda and self.P > 1:
            if self.graph_state != _addresses(state):
                self._capture(state)
            with span("train.replay", self.P):
                self.graph.replay()
            state.step += self.P
        else:
            with span("train.eager", self.P):
                self._run(state, range(self.P))
        if self.P > 1:
            with span("train.draw", self.P):
                before = _states(gens)
                try:
                    self.draw(step0 + self.P, gen_batch, gen_step)
                    self.pending = (gens, step0 + self.P, before, _states(gens))
                finally:    # a draw that raised leaves the generators as it found them too
                    _set_states(gens, before)
        if self.cfg.debug_nans and self.P > 1:
            ok = self.finite.cpu()
            names = check_names(state)
            for k in range(self.P):
                raise_non_finite(step0 + k, names, ok[k])
        return {key: self.auxs[:, i] for i, key in enumerate(self.keys)}

    def _take_ahead(self, step0: int, gens) -> bool:
        """Whether the draw made ahead holds for this call (module docstring); if so the
        generators move on to where it left them."""
        if self.pending is None:
            return False
        (drew_with, step, before, after), self.pending = self.pending, None
        if not (all(a is b for a, b in zip(drew_with, gens)) and step == step0
                and all(torch.equal(s, t) for s, t in zip(_states(gens), before))):
            self.ahead["discarded"] += 1
            return False
        _set_states(gens, after)
        self.ahead["used"] += 1
        return True

    def _capture(self, state: TrainState) -> None:
        """Warm up on the capture stream, restore the state, capture the P steps."""
        self.graph = None
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        saved = _snapshot(state)

        def warmup():
            self._run(state, range(min(WARMUP_STEPS, self.P)))
            _restore(state, saved)

        self.graph, _ = capture_graph(self.stream, warmup, lambda: self._run(state, range(self.P)))
        state.step = saved["step"]
        self.graph_state = _addresses(state)


def _states(gens) -> List[torch.Tensor]:
    return [g.get_state() for g in gens]


def _set_states(gens, states) -> None:
    for g, s in zip(gens, states):
        g.set_state(s)


def _params(state: TrainState) -> List[torch.Tensor]:
    return [*state.params_coarse.values(), *state.params_fine.values()]


def _addresses(state: TrainState):
    """The device addresses a captured step reads and writes: parameters, Adam's state."""
    adam = state.opt.state
    return tuple((p.data_ptr(), *(t.data_ptr() for t in adam.get(p, {}).values()
                                  if isinstance(t, torch.Tensor)))
                 for p in _params(state))


def _snapshot(state: TrainState) -> dict:
    adam = state.opt.state
    return dict(step=state.step, params=[p.detach().clone() for p in _params(state)],
                adam=[{k: v.clone() for k, v in adam[p].items()} if p in adam else None
                      for p in _params(state)])


@torch.no_grad()
def _restore(state: TrainState, saved: dict) -> None:
    """Parameters and Adam's state back to ``saved``, in place (the graph keeps their
    addresses); a state that did not exist yet goes back to Adam's fresh zeros."""
    state.step = saved["step"]
    for p, v, before in zip(_params(state), saved["params"], saved["adam"]):
        p.copy_(v)
        p.grad = None
        for k, t in state.opt.state[p].items():
            if before is None:
                t.zero_()
            else:
                t.copy_(before[k])
