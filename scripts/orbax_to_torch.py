"""Convert a training checkpoint of the JAX package (Orbax) into the PyTorch port's.

    python scripts/orbax_to_torch.py <jax_run_dir> <out_run_dir> [--step N]

Reads ``<jax_run_dir>/checkpoints/<step:06d>`` (the latest step unless ``--step``),
which ``dmnerf_tpu.utils.checkpoint.save_checkpoint`` writes, and writes
``<out_run_dir>/checkpoints/<step:06d>.pt`` with the parameters and the Adam state
(``dmnerf_tpu_torch.utils.checkpoint.checkpoint_from_numpy``). The port then renders
from it, or resumes training from it (``ft_path``, or ``resume`` in that run dir).

This script sits outside ``dmnerf_tpu_torch`` because it imports ``orbax.checkpoint``,
which needs JAX: run it where JAX is installed. The package imports neither, so it
runs on a card host that has none, and there it reads the ``.pt`` file this writes.
It imports nothing of ``dmnerf_tpu``: it reads the checkpoint's tree as numpy.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


def restore_numpy(run_dir: str, step=None) -> dict:
    """The Orbax checkpoint of ``step`` (default: the latest) under ``run_dir`` as a
    tree of numpy arrays, read without a template."""
    import orbax.checkpoint as ocp

    ckdir = os.path.join(run_dir, "checkpoints")
    if step is None:
        steps = [int(f) for f in os.listdir(ckdir) if re.fullmatch(r"\d+", f)] \
            if os.path.isdir(ckdir) else []
        if not steps:
            raise FileNotFoundError(f"no Orbax checkpoint under {ckdir}")
        step = max(steps)
    path = os.path.abspath(os.path.join(ckdir, f"{step:06d}"))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no Orbax checkpoint at {path}")
    return _numpy(ocp.StandardCheckpointer().restore(path))


def convert(run_dir: str, out_dir: str, step=None) -> str:
    """Convert one checkpoint; returns the path of the port's checkpoint file."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from dmnerf_tpu_torch.utils.checkpoint import checkpoint_from_numpy, save_checkpoint

    return save_checkpoint(out_dir, *checkpoint_from_numpy(restore_numpy(run_dir, step)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir", help="the JAX run dir (holding checkpoints/<step>)")
    ap.add_argument("out_dir", help="the port's run dir to write checkpoints/<step>.pt into")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    print(f"wrote {convert(args.run_dir, args.out_dir, args.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
