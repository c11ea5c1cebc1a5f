"""Faults planted under the timed path, to show that ``correct`` catches them: each is a
context manager that patches one function of the program while it is open.

 * ``frozen``: every train step returns its state unchanged (the program's Adam skips
   its update);
 * ``half_batch``: a train step's losses taken over the first half of its rays alone (for
   ScanNet this leaves out the labelled suffix);
 * ``stale_batch``: every pack after the first replays the first pack's inputs (its ray ids,
   learning rates and uniforms), as a replay that read stale static buffers would;
 * ``half_view``: every other render chunk's maps left out (zeros);
 * ``altered``: every view's rgb shifted by 2/255 where it is produced;
 * ``no_exchange``: the manipulator's exchange left out.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = ("frozen", "half_batch", "stale_batch", "half_view", "altered", "no_exchange")


@contextlib.contextmanager
def _patched(module, name: str, value) -> Iterator[None]:
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def planted(fault: str):
    """The context manager of ``fault`` (one of ``FAULTS``)."""
    if fault == "frozen":
        from dmnerf_tpu_torch.render import trainstep

        make = trainstep.make_adam

        def frozen(*args, **kw):
            opt = make(*args, **kw)
            opt.step = lambda closure=None: None
            return opt

        return _patched(trainstep, "make_adam", frozen)
    if fault == "half_batch":
        from dmnerf_tpu_torch.render import trainstep

        whole = trainstep.compute_losses

        def half(cfg, info, batch, n_ins, reduce=None):
            n = batch.rays_o.shape[0]
            rows = slice(0, n // 2)
            part = {k: v[rows] if v.dim() and v.shape[0] == n else v for k, v in info.items()}
            return whole(cfg, part, trainstep.Batch(*(None if x is None else x[rows]
                                                      for x in batch)), n_ins, reduce)

        return _patched(trainstep, "compute_losses", half)
    if fault == "stale_batch":
        from dmnerf_tpu_torch.render import packing

        fresh = packing.StepRunner.draw
        first: dict = {}

        def stale(self, step, gen_batch, gen_step):
            fresh(self, step, gen_batch, gen_step)      # the generators move on
            bufs = [b for b in (self.dev, self.u_z, self.u_pdf) if b is not None]
            if id(self) not in first:
                first[id(self)] = [b.clone() for b in bufs]
            else:
                for b, kept in zip(bufs, first[id(self)]):
                    b.copy_(kept)

        return _patched(packing.StepRunner, "draw", stale)
    if fault in ("half_view", "altered"):
        from dmnerf_tpu_torch.render import manipulator, renderer

        maps = renderer.composite_maps
        calls = [0]

        def broken(raw, z, d, keep_air=False):
            rgb, ins, depth = maps(raw, z, d, keep_air)
            calls[0] += 1
            if fault == "altered":
                return rgb + 2.0 / 255.0, ins, depth
            if calls[0] % 2:
                return rgb * 0, ins * 0, depth * 0
            return rgb, ins, depth

        stack = contextlib.ExitStack()
        for module in (renderer, manipulator):     # the view's and the manipulated view's
            stack.enter_context(_patched(module, "composite_maps", broken))
        return stack
    if fault == "no_exchange":
        from dmnerf_tpu_torch.render import manipulator

        return _patched(manipulator, "exchange",
                        lambda ori_raw, tar_raws, *a: (ori_raw, list(tar_raws), None, None))
    raise ValueError(f"unknown fault {fault!r}")
