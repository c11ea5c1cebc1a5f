"""Packed training, closed loop: ``train.build_sampler_and_step``'s sampler (full-image, or
the crop sampler with its labelled suffix when the scene has a crop and labelled ids) and
``train.make_packed_steps``'s packs of ``steps_per_dispatch`` whole steps, one CUDA graph
a pack on the card. Each unit is one pack, counted once its losses are on the host, as
``train.py`` reads them at ``i_print``.

Set-up makes one train state and drives it from the seed through two packs: the first
captures the graph and replays it, the second replays it on fresh draws, as every pack of
the window does. Then it hands that same state to the window. The check: the reference
trains the same weights over the same draws for both packs' steps. The numbers, of the
first pack: the first step's loss (``loss1``), the worst step's loss (``loss``), Adam's
first moment of every tensor after the pack (``moment``: the gradients as the optimizer
took them) and every tensor's change over it (``change``), each of the two by the worst
tensor (``self.worst`` names it) and by the median tensor (``moment_med``, ``change_med``);
of the second pack the same as ``loss2``, ``moment2``, ``change2``, ``moment2_med`` and
``change2_med``, its change counted from the start. A pack is one graph, so its state is
seen only at its end. Which of them a cell compares, and at what limit, its
``limits/<cell>.json`` says.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmark import compare, yardstick
from benchmark.drivers import (Unit, build, program_config, release_cuda, scene_data, stage,
                               sub_seed)
from benchmark.reference.nerf import fp32_matmul
from benchmark.reference import train as ref_train
from benchmark.scene import make_scene
from benchmark.weights import make_models


SETUP_PACKS = 2     # the capture's pack and a replay on fresh draws: the steps the check follows


def _host(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix} {k}": v.detach().to("cpu", copy=True) for k, v in params.items()}


class Driver:
    kind = "train"

    def __init__(self, conf: dict, mix: dict, seed: int, device: torch.device):
        self.conf, self.mix, self.seed, self.device = conf, mix, seed, device

    def setup(self) -> None:
        from dmnerf_tpu_torch.render.trainstep import create_train_state
        from dmnerf_tpu_torch.train import build_sampler_and_step

        conf, dev = self.conf, self.device
        stage("imports")
        build(conf, "train", dev)
        stage("build")
        self.scene = make_scene(conf, torch.Generator(dev).manual_seed(sub_seed(self.seed, "scene")))
        pc, pf = make_models(conf, sub_seed(self.seed, "weights"), dev)
        stage("scene and weights", dev)
        cfg = program_config(conf, self.mix)
        _, _, _, packed = build_sampler_and_step(cfg, scene_data(self.scene), dev)
        if packed is None:
            raise ValueError("the train mix needs steps_per_dispatch > 1")
        self.packed, self.P = packed
        self.state = create_train_state(cfg, pc, pf)
        self.init = {**_host(pc, "coarse"), **_host(pf, "fine")}
        del pc, pf
        stage("sampler and state", dev)
        self.gen_batch = torch.Generator().manual_seed(sub_seed(self.seed, "batch"))
        self.gen_step = torch.Generator(dev).manual_seed(sub_seed(self.seed, "step"))
        self.trained = ref_train.Trained([], {})
        self._set_pack()
        stage("first pack: capture and replay", dev)
        for _ in range(SETUP_PACKS - 1):
            self._set_pack()
        stage("second pack: replay", dev)

    def _set_pack(self) -> None:
        """One of the set-up's packs: its losses and the state after it kept for the check."""
        auxs = self.packed(self.state, self.gen_batch, self.gen_step)
        self.trained.losses += auxs["total_loss"].tolist()
        opt = self.state.opt.state

        def moment(p):     # an Adam that never stepped holds none: zeros
            m = opt.get(p, {}).get("exp_avg")
            return torch.zeros(p.shape) if m is None else m.to("cpu", copy=True)

        params = {f"coarse {k}": p for k, p in self.state.params_coarse.items()}
        params.update({f"fine {k}": p for k, p in self.state.params_fine.items()})
        self.trained.states[len(self.trained.losses)] = (
            {k: moment(p) for k, p in params.items()},
            {k: p.detach().to("cpu", copy=True) for k, p in params.items()})

    def _pack(self) -> torch.Tensor:
        auxs = self.packed(self.state, self.gen_batch, self.gen_step)
        return auxs["total_loss"].cpu()

    def unit(self) -> Unit:
        import time

        t0 = time.perf_counter()
        losses = self._pack()
        return Unit(rays=self.P * self.conf["N_train"], seconds=time.perf_counter() - t0,
                    finite=bool(torch.isfinite(losses).all()), attempted=self.P)

    def verify(self, units) -> None:
        """Nothing to do: each pack's losses were read when it ended."""

    def work(self, units: int) -> dict:
        c, n = self.conf, self.conf["N_train"]
        steps = units * self.P
        queries: List[dict] = []
        for _ in range(steps):
            for pts in (n * c["N_samples"], n * (c["N_samples"] + c["N_importance"])):
                for p in ("fwd", "bwd"):
                    queries.append({"points": pts, "rays": n, "model": "full", "pass": p})
        return {"steps": steps, "flops": steps * yardstick.train_step_flops(c),
                "queries": queries}

    def release(self) -> None:
        del self.state, self.packed
        release_cuda(self.device)

    def reference(self, prec: str = "fp32", first_grads=None) -> ref_train.Trained:
        """The reference's training over the set-up's packs' steps, its state kept after
        each pack."""
        conf, dev, scene = self.conf, self.device, self.scene
        pc, pf = make_models(conf, sub_seed(self.seed, "weights"), dev)
        gen_batch = torch.Generator().manual_seed(sub_seed(self.seed, "batch"))
        gen_step = torch.Generator(dev).manual_seed(sub_seed(self.seed, "step"))
        draw = ref_train.crop_batches if scene.ins_indices is not None else ref_train.full_batches
        with fp32_matmul():
            batches = draw(scene, conf, SETUP_PACKS * self.P, gen_batch, gen_step)
            return ref_train.train(pc, pf, batches, conf, prec, first_grads,
                                   at=[k * self.P for k in range(1, SETUP_PACKS + 1)])

    def check(self, prec: str = "fp32") -> Dict[str, float]:
        """The program's set-up packs against the reference's (``prec``: the reference's
        operands, fp8 for the control): the numbers of the module's docstring."""
        grads: Dict[str, torch.Tensor] = {}
        ref = self.reference("fp32", grads)
        keys = compare.moving(grads)
        prog = self.trained if prec == "fp32" else self.reference(prec)
        P = self.P
        numbers = {"loss1": compare.worst_relative(prog.losses[:1], ref.losses[:1])}
        self.worst = {}
        for n in range(1, SETUP_PACKS + 1):
            k, suffix = n * P, "" if n == 1 else str(n)
            numbers[f"loss{suffix}"] = compare.worst_relative(prog.losses[k - P:k],
                                                              ref.losses[k - P:k])
            if k not in prog.states:
                numbers.update({f"moment{suffix}": float("inf"), f"change{suffix}": float("inf")})
                continue
            (p_moment, p_params), (moment, params) = prog.states[k], ref.states[k]
            init = {n: self.init[n].to(params[n].device) for n in params}
            moments = compare.leaf_norm_gaps(p_moment, moment, keys)
            changes = compare.leaf_norm_gaps(
                {n: v.to(params[n].device) - init[n] for n, v in p_params.items()},
                {n: params[n] - init[n] for n in params}, keys)
            numbers[f"moment{suffix}"] = max(moments.values())
            numbers[f"change{suffix}"] = max(changes.values())
            numbers[f"moment{suffix}_med"] = statistics.median(moments.values())
            numbers[f"change{suffix}_med"] = statistics.median(changes.values())
            self.worst[f"moment{suffix}"] = max(moments, key=moments.get)
            self.worst[f"change{suffix}"] = max(changes, key=changes.get)
        return numbers
