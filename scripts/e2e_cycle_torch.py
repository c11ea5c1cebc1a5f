"""The port's command-line cycle, as a user runs it: write a scene, train, kill the run,
resume it, then evaluate the trained model in every test mode.

    python3 scripts/e2e_cycle_torch.py [--family dmsr|replica|scannet|all] [--long | --smoke]
        [--scene KEY=VALUE ...] [--device cuda|cpu] [--work DIR] [--out DIR]

For each loader family it writes a synthetic scene with the port's writer
(``dmnerf_tpu_torch.data.synthetic``), then runs the two entry points in subprocesses
(``python -m dmnerf_tpu_torch.train`` / ``.test``) from the shipped configs of that
family, with the overrides ``cycle`` sets (each recorded):

1. train, packed (``steps_per_dispatch`` 10), with ``N_iters`` far past the kill point;
   SIGTERM once the first checkpoint is on disk (``--long``: once iteration 52,500 is
   logged), wherever the run then is;
2. the same command with the run's ``N_iters``: it resumes from the newest checkpoint.
   Its ``[report]`` line (``$DMNERF_REPORT``) gives the digest of the state it restored,
   held bit for bit to the checkpoint file's (``utils.checkpoint.state_digest``); the
   mean F_PSNR of the first ``RESUME_WINDOWS`` logged windows after the resume is held to
   at most ``MAX_RESUME_DROP_DB`` below that of the last ones before the kill (a window
   logs one step's batch, whose PSNR swings by 1-3 dB from window to window early in a
   run; the single values are recorded too);
3. the test modes from the final checkpoint, each of which must log ``[test] loaded
   checkpoint step N`` for the run's N: ``render`` (PSNR, SSIM, LPIPS, mAP from
   ``test_results.txt``; the same views from the seeded init too, ``no_reload``),
   and for DM-SR ``mani_eval`` (translation, target label 1, against the manipulated
   ground truth), ``mani_demo`` (seconds a frame, the first frame left out) and
   ``mesh`` (vertices and faces before and after cleaning, host seconds by stage, peak
   RSS).

The median rays/s over the run's ``metrics.jsonl`` windows (each process's first window,
which holds its start and the graph capture, left out) is the step rate. mAP@[.5:.95]
is the mean of the six AP columns of ``test_results.txt`` (.5, .75, .8, .85, .9, .95).
Each family's record goes to ``<out>/e2e_<cycle|smoke|long>.jsonl`` and a table to
``<out>/e2e_<...>.md``, with the card's ``nvidia-smi`` name and power limit and the JAX
package's quality record on its TPU beside the port's (a point of reference, not a
bar; the random streams differ). A held-out PSNR more than ``SUSPECT_PSNR_DB`` below
that record, or an mAP@.5 more than ``SUSPECT_AP`` below it, is printed as a suspected
fault. The script exits 1 when a command fails, a metric but LPIPS is not finite, a
mode did not load the trained step, or the resume check fails.

``--long`` runs docs/LONGRUN.md's setup instead (DM-SR 128², 16 objects, 100,001
iterations, ``lrate_decay`` 100, a checkpoint every 5,000, an evaluation every 10,000,
killed past 52,500 and resumed) and records the median rays/s of each 10k bucket, each
evaluation's held-out PSNR / SSIM / mAP, the peak device memory and any non-finite
logged value.

``chip_smoke.py`` phase 18 runs ``run_cycle`` at a smaller depth (``cycle(family,
"smoke")``); ``tests/test_torch_e2e_cycle.py`` at a tiny one on the CPU. The script
imports nothing of JAX; the subprocesses take the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dmnerf_tpu_torch.utils.checkpoint import checkpoint_steps, state_digest  # noqa: E402

FAMILIES = ("dmsr", "replica", "scannet")
CONFIGS = {
    "dmsr": ("configs/train/dmsr/study.txt", "configs/test/dmsr/study.txt"),
    "replica": ("configs/train/replica/office_0.txt", "configs/test/replica/office_0.txt"),
    "scannet": ("configs/train/scannet/scene0010_00.txt", "configs/test/scannet/scene0010_00.txt"),
}
MANI_CONFIG = "configs/manipulation/dmsr/manipulation_translation/study.txt"
STEPS_PER_DISPATCH = 10
MAX_RESUME_DROP_DB = 2.0    # F_PSNR after the resume against before the kill
RESUME_WINDOWS = 3          # logged windows on each side whose mean F_PSNR is compared
SUSPECT_PSNR_DB = 3.0       # held-out PSNR this far below the JAX record: a suspected fault
SUSPECT_AP = 0.15           # mAP@.5 this far below it: the same
LONG_KILL_AT = 52500

# The JAX package's cycle on its TPU (quality only; its rates were a TPU's).
JAX_RECORD = {
    "dmsr": {"psnr": 32.98, "ssim": 0.952, "ap50": 0.889, "mani_psnr": 26.02,
             "mani_ap50": 0.744, "source": "docs/TPU_E2E.md, Round-5 four-mode cycle"},
    "replica": {"psnr": 42.20, "ssim": 0.991, "ap50": 0.984,
                "source": "docs/TPU_E2E.md, Replica mode on the chip"},
    "scannet": {"psnr": 31.11, "ssim": 0.882, "ap50": 1.0,
                "source": "docs/TPU_E2E.md, ScanNet mode on the chip"},
    "long": {"by_step": {10000: (36.43, 0.9847, 0.856, 0.652), 30000: (37.47, 0.9874, 0.936, 0.765),
                         50000: (37.40, 0.9868, 0.938, 0.779), 80000: (37.14, 0.9868, 0.938, 0.798),
                         100000: (37.33, 0.9870, 0.938, 0.791)},
             "source": "docs/LONGRUN.md (PSNR, SSIM, mAP@.5, mAP@[.5:.95])"},
}


class CycleError(AssertionError):
    pass


@dataclasses.dataclass(frozen=True)
class Cycle:
    """One family's cycle: the scene (the writer's keyword arguments), the run's
    schedule, the test modes and the config keys the synthetic scene needs beside the
    shipped config's (``keys``, for the train and every test command)."""
    family: str
    scene: dict
    iters: int
    i_save: int
    i_print: int
    modes: tuple = ("render",)
    keys: dict = dataclasses.field(default_factory=dict)
    i_test: int = 10 ** 9
    kill_at: int = 0             # SIGTERM at the first logged iteration >= this past a checkpoint
    mesh_grid_dim: int = 256
    # at N_importance 128 (docs/TPU_E2E.md "Mesh iso-level"); 300 iterations leave the
    # density softer, its occupancy under 0.07 (smoke)
    mesh_level: float = 0.08
    demo_views: int = 5
    timeout: float = 1800.0      # seconds a command may take

    @property
    def first_iters(self) -> int:
        """N_iters of the launch that is killed: far past its kill point."""
        return max(10 * self.iters, self.kill_at + 10 * self.i_save)


def cycle(family: str, depth: str = "full") -> Cycle:
    """The cycle of ``family`` at ``depth``: "full" (the JAX record's scenes and
    iterations, docs/TPU_E2E.md), "smoke" (``chip_smoke.py`` phase 18: 64² DM-SR, 96x128
    Replica and ScanNet, 300 iterations, the first checkpoint at 150), or "long"
    (DM-SR only, docs/LONGRUN.md)."""
    full = depth != "smoke"
    if family == "dmsr" and depth == "long":
        return Cycle("dmsr", dict(H=128, W=128, n_objects=16, ins_num=20, seed=3, n_train=25,
                                  n_test=4), iters=100001, i_save=5000, i_print=500,
                     i_test=10000, modes=(), kill_at=LONG_KILL_AT, timeout=3300.0,
                     keys=dict(near=1.0, far=8.0, lrate_decay=100))
    iters, i_save, i_print = (10001, 5000, 100) if full else (301, 150, 10)
    if family == "dmsr":
        side = 96 if full else 64
        # the spheres lie 2.2-5.8 from the cameras; study.txt's near 4 would cut them
        return Cycle("dmsr", dict(H=side, W=side, n_objects=5, ins_num=8,
                                  mani_modes=["translation"]),
                     iters=iters, i_save=i_save, i_print=i_print,
                     modes=("render", "mani_eval", "mani_demo", "mesh"),
                     keys=dict(near=1.0, far=8.0), mesh_grid_dim=256 if full else 128,
                     mesh_level=0.08 if full else 0.03, demo_views=5 if full else 2)
    iters, i_save = (3001, 1500) if full else (iters, i_save)
    if family == "replica":
        # office_0's far 4.7 would cut spheres up to 5.8 away; the writer wrote the
        # frames a loader with testskip 10 reads
        return Cycle("replica", dict(H=96, W=128, n_objects=6, testskip=10), iters=iters,
                     i_save=i_save, i_print=i_print, keys=dict(far=8.0, testskip=10))
    if family == "scannet":
        # the writer's intrinsics are the 96x128 frames' (no resize to 640x480); a
        # 96x64 centre crop; the embedding kernel and the query over embeddings
        return Cycle("scannet", dict(H=96, W=128, n_objects=6, unlabeled_frac=0.5),
                     iters=iters, i_save=i_save, i_print=i_print,
                     keys=dict(resize=False, crop_width=96, crop_height=64,
                               pallas_pe_mode="outside"))
    raise ValueError(f"unknown family {family!r}")


# ---- commands ----

def _fmt(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return ",".join(map(str, v)) if isinstance(v, tuple) else str(v)


def command(module: str, config: str, keys: dict, device: str) -> list:
    """``python -u -m <module> --config <config> key=value ...`` (``--device cpu`` on the
    CPU; the entry points take the card by default)."""
    argv = [sys.executable, "-u", "-m", module, "--config", os.path.join(REPO, config)]
    argv += [f"{k}={_fmt(v)}" for k, v in keys.items()]
    return argv + (["--device", "cpu"] if device == "cpu" else [])


class _Command:
    """A subprocess whose stdout and stderr lines are teed into a log file and read
    here as they come."""

    def __init__(self, argv, log_path: str):
        env = dict(os.environ, DMNERF_REPORT="1")
        self.argv, self.log_path, self.lines = argv, log_path, []
        self.proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True, env=env)
        self._q: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        with open(self.log_path, "w") as log:
            log.write(" ".join(self.argv) + "\n")
            for line in self.proc.stdout:
                log.write(line)
                log.flush()
                self._q.put(line.rstrip("\n"))
        self._q.put(None)

    def follow(self, timeout: float, until=None) -> bool:
        """Reads lines until ``until(line)`` holds (True) or the output ends (False); past
        ``timeout`` seconds the process is killed and CycleError raised."""
        deadline = time.time() + timeout
        while True:
            try:
                line = self._q.get(timeout=max(0.0, deadline - time.time()))
            except queue.Empty:
                self.kill()
                raise CycleError(f"{self.log_path}: no end within {timeout:.0f} s")
            if line is None:
                return False
            self.lines.append(line)
            if until is not None and until(line):
                return True

    def finish(self, timeout: float) -> int:
        self.follow(timeout)
        return self.proc.wait(timeout=60)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def reports(self) -> list:
        return [json.loads(line[len("[report] "):]) for line in self.lines
                if line.startswith("[report] ")]


def run_command(argv, log_path: str, timeout: float) -> _Command:
    """Runs a command to its end; CycleError unless it exits 0."""
    cmd = _Command(argv, log_path)
    try:
        rc = cmd.finish(timeout)
    finally:
        cmd.kill()
    if rc != 0:
        tail = "\n".join(cmd.lines[-30:])
        raise CycleError(f"{' '.join(argv[2:5])} exited {rc} (log {log_path}):\n{tail}")
    return cmd


# ---- what the files say ----

def _records(log_dir: str) -> list:
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def file_digest(log_dir: str, step: int) -> dict:
    """The state digest of the checkpoint file of ``step``, read on the host."""
    import torch

    payload = torch.load(os.path.join(log_dir, "checkpoints", f"{step:06d}.pt"),
                         map_location="cpu", weights_only=True)
    return state_digest(payload["params_coarse"], payload["params_fine"], payload["opt_state"])


def results_row(path: str) -> dict:
    """The mean row of a test_results.txt (PSNR SSIM LPIPS AP@.5 .75 .8 .85 .9 .95)."""
    rows = np.atleast_2d(np.loadtxt(path))
    mean = rows[-1]
    return {"psnr": float(mean[0]), "ssim": float(mean[1]), "lpips": float(mean[2]),
            "ap50": float(mean[3]), "map": float(np.mean(mean[3:9])),
            "aps": [float(x) for x in mean[3:9]], "views": int(len(rows) - 1)}


def _after(lines, prefix: str) -> Optional[str]:
    hits = [line[len(prefix):].strip() for line in lines if line.startswith(prefix)]
    return hits[-1] if hits else None


def _loaded_step(lines) -> Optional[int]:
    for line in lines:
        m = re.match(r"\[test\] loaded checkpoint step (\d+) from", line)
        if m:
            return int(m.group(1))
    return None


def _launches(cmds) -> dict:
    out: Dict[str, int] = {}
    for cmd in cmds:
        for rep in cmd.reports():
            for name, n in rep.get("launches", {}).items():
                out[name] = out.get(name, 0) + n
    return out


def non_finite(obj, path="") -> list:
    """The paths of the numbers in ``obj`` that are not finite, but LPIPS (NaN without
    its weights)."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items() if k != "lpips" for p in non_finite(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj) for p in non_finite(v, f"{path}[{i}]")]
    if isinstance(obj, float) and not np.isfinite(obj):
        return [path]
    return []


def smi() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _rates(recs) -> list:
    """rays/s of each logged window but each process's first (its start and capture)."""
    out, last = [], None
    for r in recs:
        if last is not None and r["step"] > last:
            out.append(r["rays_per_sec"])
        last = r["step"]
    return out


# ---- the cycle ----

def write_scene(c: Cycle, datadir: str) -> None:
    from dmnerf_tpu_torch.data import synthetic

    writer = {"dmsr": synthetic.write_dmsr_scene, "replica": synthetic.write_replica_scene,
              "scannet": synthetic.write_scannet_scene}[c.family]
    writer(datadir, **c.scene)


def train_keys(c: Cycle, datadir: str, basedir: str, n_iters: int) -> dict:
    return {"datadir": datadir, "basedir": basedir, "expname": c.family, "N_iters": n_iters,
            "i_print": c.i_print, "i_save": c.i_save, "i_test": c.i_test,
            "steps_per_dispatch": STEPS_PER_DISPATCH, **c.keys}


def mode_commands(c: Cycle, run: dict, device: str) -> dict:
    """The test commands of the cycle's modes, by name, against the run's checkpoints."""
    base = {"datadir": run["datadir"], "basedir": run["basedir"], "expname": c.family, **c.keys}
    test_cfg = CONFIGS[c.family][1]
    out = {}
    for mode in c.modes:
        if mode == "render":
            out["render"] = command("dmnerf_tpu_torch.test", test_cfg, base, device)
            out["render_init"] = command("dmnerf_tpu_torch.test", test_cfg,
                                         {**base, "no_reload": True}, device)
        elif mode == "mani_eval":
            # the scene's 4 manipulated views (the config's testskip 5 would keep one)
            out[mode] = command("dmnerf_tpu_torch.test", MANI_CONFIG,
                                {**base, "testskip": 1, "target_label": 1}, device)
        elif mode == "mani_demo":
            out[mode] = command("dmnerf_tpu_torch.test", MANI_CONFIG,
                                {**base, "mani_eval": False, "mani_demo": True,
                                 "views": c.demo_views}, device)
        elif mode == "mesh":
            out[mode] = command("dmnerf_tpu_torch.test", test_cfg,
                                {**base, "render": False, "mesh": True,
                                 "mesh_grid_dim": c.mesh_grid_dim, "mesh_level": c.mesh_level},
                                device)
        else:
            raise ValueError(f"unknown test mode {mode!r}")
    return out


def _mode_result(name: str, cmd: _Command) -> dict:
    lines = cmd.lines
    if name in ("render", "render_init"):
        savedir = _after(lines, "Rendering Done")
        return results_row(os.path.join(savedir, "test_results.txt"))
    if name == "mani_eval":
        savedir = _after(lines, "Manipulating Done")
        return results_row(os.path.join(savedir, "translation", "test_results.txt"))
    if name == "mani_demo":
        times = [float(m.group(1)) for line in lines
                 if (m := re.match(r"\[mani_demo\] Image\d+: ([\d.]+)s", line))]
        savedir = _after(lines, "Manipulating Done")
        pngs = sorted(f for f in os.listdir(os.path.join(savedir, "mani_output"))
                      if f.endswith("_rgb.png"))
        return {"frames": len(times), "s_per_frame_warm": statistics.median(times[1:] or times),
                "s_first_frame": times[0], "rgb_pngs": len(pngs)}
    if name == "mesh":
        out = {}
        for line in lines:
            if m := re.match(r"\[mesh\] fraction occupied: ([\d.]+)", line):
                out["fraction_occupied"] = float(m.group(1))
            if m := re.match(r"\[mesh\] mesh\.ply: (\d+) verts, (\d+) faces", line):
                out["verts"], out["faces"] = int(m.group(1)), int(m.group(2))
            if m := re.match(r"\[mesh\] cleaned: (\d+) verts, (\d+) faces", line):
                out["clean_verts"], out["clean_faces"] = int(m.group(1)), int(m.group(2))
            if line.startswith("[mesh] color_mesh.ply written; host seconds "):
                body, rss = line[len("[mesh] color_mesh.ply written; host seconds "):].split("; peak RSS ")
                out["seconds"] = {k: float(v) for k, v in (s.strip().split(" ") for s in body.split(","))}
                out["peak_rss_gb"] = float(rss.split()[0])
        savedir = _after(lines, "Meshing Done")
        out["files"] = sorted(f for f in os.listdir(savedir) if f.endswith(".ply"))
        if "clean_verts" not in out or "color_mesh.ply" not in out["files"]:
            raise CycleError(f"mesh: no coloured mesh written (log {cmd.log_path})")
        return out
    raise ValueError(name)


def train_and_resume(c: Cycle, run: dict, device: str, logs: str) -> dict:
    """Steps 1 and 2 of the docstring; returns the kill's and the resume's record."""
    log_dir = os.path.join(run["basedir"], c.family, "run")
    state = {"ckpt": False}

    def at_kill_point(line: str) -> bool:
        if line.startswith("[train] checkpoint "):
            state["ckpt"] = True
            return c.kill_at == 0
        m = re.match(r"\[TRAIN\] Iter: (\d+) ", line)
        return bool(state["ckpt"] and c.kill_at and m and int(m.group(1)) >= c.kill_at)

    t0 = time.time()
    first = _Command(command("dmnerf_tpu_torch.train", CONFIGS[c.family][0],
                             train_keys(c, run["datadir"], run["basedir"], c.first_iters), device),
                     os.path.join(logs, "train_first.log"))
    try:
        reached = first.follow(c.timeout, at_kill_point)
        if not reached:
            raise CycleError(f"the first launch ended (rc {first.proc.wait()}) before its kill "
                             f"point (log {first.log_path}):\n" + "\n".join(first.lines[-30:]))
        first.proc.send_signal(signal.SIGTERM)
        rc = first.finish(120)
    finally:
        first.kill()
    first_s = time.time() - t0
    recs = _records(log_dir)
    steps = sorted(checkpoint_steps(log_dir))
    if not steps:
        raise CycleError(f"no checkpoint on disk after the kill ({log_dir})")
    newest = steps[-1]
    if newest >= c.iters:
        raise CycleError(f"the kill landed past the run's end: newest checkpoint {newest}, "
                         f"N_iters {c.iters}")
    stray = sorted(f for f in os.listdir(os.path.join(log_dir, "checkpoints"))
                   if not re.fullmatch(r"\d+\.pt", f))
    want = file_digest(log_dir, newest)

    t0 = time.time()
    second = run_command(command("dmnerf_tpu_torch.train", CONFIGS[c.family][0],
                                 train_keys(c, run["datadir"], run["basedir"], c.iters), device),
                         os.path.join(logs, "train_resumed.log"), c.timeout)
    resumed_s = time.time() - t0
    all_recs = _records(log_dir)
    after = all_recs[len(recs):]
    m = re.fullmatch(r"from step (\d+)", _after(second.lines, "[train] resumed") or "")
    resumed_line = int(m.group(1)) if m else None
    got = next((r for r in second.reports() if "resumed_step" in r), {})
    final = next((r for r in second.reports() if "launches" in r), {})
    last_before, first_after = (recs[-1] if recs else None), (after[0] if after else None)
    drop = (statistics.mean(r["psnr_fine"] for r in recs[-RESUME_WINDOWS:])
            - statistics.mean(r["psnr_fine"] for r in after[:RESUME_WINDOWS])
            if last_before and first_after else None)
    resume = {
        "killed_rc": rc, "killed_after_s": first_s, "newest_checkpoint": newest,
        "checkpoints_at_kill": steps, "stray_files": stray,
        "resumed_line_step": resumed_line, "report_step": got.get("resumed_step"),
        "digest_file": want, "digest_restored": got.get("digest"),
        "bits_equal": got.get("digest") == want and got.get("resumed_step") == newest,
        "last_before_kill": last_before, "first_after_resume": first_after,
        "psnr_drop_db": drop, "resumed_s": resumed_s, "psnr_drop_db_single": (
            last_before["psnr_fine"] - first_after["psnr_fine"]
            if last_before and first_after else None),
    }
    resume["ok"] = bool(resume["bits_equal"] and resumed_line == newest and drop is not None
                        and drop <= MAX_RESUME_DROP_DB)
    rates = _rates(recs) + _rates(after)
    train = {
        "records": len(all_recs), "last": all_recs[-1] if all_recs else None,
        "rays_per_sec_median": statistics.median(rates) if rates else None,
        "rays_per_sec_windows": len(rates), "final_checkpoint": max(checkpoint_steps(log_dir)),
        "peak_device_gb": final.get("peak_device_gb"),
        "non_finite_logged": [f"step {r['step']}: {k}" for r in all_recs for k, v in r.items()
                              if isinstance(v, float) and not np.isfinite(v)],
    }
    return {"log_dir": log_dir, "resume": resume, "train": train,
            "launches_train": _launches([second])}


def run_cycle(c: Cycle, work: str, device: str = "cuda") -> dict:
    """The whole cycle of ``c`` under ``work`` (scene, runs, logs). Returns its record;
    ``record["failures"]`` lists what the script exits 1 on."""
    t_start = time.time()
    root = os.path.join(work, c.family)
    run = {"datadir": os.path.join(root, "scene"), "basedir": os.path.join(root, "logs")}
    logs = os.path.join(root, "commands")
    os.makedirs(logs, exist_ok=True)
    t0 = time.time()
    write_scene(c, run["datadir"])
    rec = {"family": c.family, "device": device, "scene": c.scene, "scene_write_s": time.time() - t0,
           "configs": {"train": CONFIGS[c.family][0], "test": CONFIGS[c.family][1],
                       **({"mani": MANI_CONFIG} if {"mani_eval", "mani_demo"} & set(c.modes) else {})},
           "overrides": {**train_keys(c, "<scene>", "<work>", c.iters),
                         "first_launch_N_iters": c.first_iters},
           "kill": "after iteration %d" % c.kill_at if c.kill_at else "at the first checkpoint"}
    rec.update(train_and_resume(c, run, device, logs))
    failures = []
    if not rec["resume"]["ok"]:
        failures.append(f"resume: {json.dumps({k: rec['resume'][k] for k in ('bits_equal', 'newest_checkpoint', 'resumed_line_step', 'report_step', 'psnr_drop_db')})}")
    final_step = rec["train"]["final_checkpoint"]
    if final_step != c.iters:
        failures.append(f"final checkpoint {final_step}, N_iters {c.iters}")

    modes, test_cmds = {}, []
    for name, argv in mode_commands(c, run, device).items():
        t0 = time.time()
        try:
            cmd = run_command(argv, os.path.join(logs, f"test_{name}.log"), c.timeout)
            test_cmds.append(cmd)
            res = _mode_result(name, cmd)
        except CycleError as e:
            failures.append(f"{name}: {e}")
            modes[name] = {"error": str(e)}
            continue
        res["command_s"] = time.time() - t0
        res["loaded_step"] = _loaded_step(cmd.lines)
        if name != "render_init" and res["loaded_step"] != c.iters:
            failures.append(f"{name}: loaded step {res['loaded_step']}, want {c.iters}")
        if name == "mesh":
            res["overrides"] = {"mesh_grid_dim": c.mesh_grid_dim, "mesh_level": c.mesh_level}
        modes[name] = res
    rec["modes"] = modes
    rec["launches"] = {f"cli_train_{c.family}": rec.pop("launches_train"),
                       f"cli_test_{c.family}": _launches(test_cmds)}
    if "psnr" in modes.get("render", {}) and "psnr" in modes.get("render_init", {}):
        gain = modes["render"]["psnr"] - modes["render_init"]["psnr"]
        rec["render_psnr_over_init_db"] = gain
        ref = JAX_RECORD.get(c.family)
        if ref:
            suspect = []
            if modes["render"]["psnr"] < ref["psnr"] - SUSPECT_PSNR_DB:
                suspect.append(f"held-out PSNR {modes['render']['psnr']:.2f} < JAX "
                               f"{ref['psnr']} - {SUSPECT_PSNR_DB}")
            if modes["render"]["ap50"] < ref["ap50"] - SUSPECT_AP:
                suspect.append(f"mAP@.5 {modes['render']['ap50']:.3f} < JAX {ref['ap50']} - "
                               f"{SUSPECT_AP}")
            rec["suspected_fault"] = suspect
    bad = non_finite({k: v for k, v in rec.items() if k not in ("resume",)})
    bad += rec["train"]["non_finite_logged"]
    if bad:
        failures.append(f"not finite: {bad}")
    rec["failures"] = failures
    rec["seconds"] = time.time() - t_start
    return rec


def long_summary(rec: dict) -> dict:
    """The long run's buckets, held-out trajectory and resume."""
    recs = _records(rec["log_dir"])
    buckets: Dict[int, list] = {}
    last = None
    for r in recs:
        if last is not None and r["step"] > last:
            # the window logged at step s ends at s: steps 1-10,000 are the first bucket
            buckets.setdefault((r["step"] - 1) // 10000, []).append(r["rays_per_sec"])
        last = r["step"]
    evals = {}
    for d in sorted(os.listdir(rec["log_dir"])):
        m = re.fullmatch(r"testset_(\d+)", d)
        path = os.path.join(rec["log_dir"], d, "test_results.txt")
        if m and os.path.exists(path):
            evals[int(m.group(1))] = results_row(path)
    return {"rays_per_sec_by_10k": {f"{10 * k}-{10 * k + 10}k": statistics.median(v)
                                    for k, v in sorted(buckets.items())},
            "held_out": evals}


# ---- output ----

def _f(x, nd=2):
    return "—" if x is None else f"{x:.{nd}f}" if isinstance(x, float) else str(x)


def markdown(records: list, card: Optional[str]) -> str:
    lines = [f"Card: {card or 'none (CPU)'}", "",
             "| family | held-out PSNR | SSIM | mAP@.5 | mAP@[.5:.95] | PSNR from the seeded init | "
             "rays/s (median window) | resume (step, bits, ΔF_PSNR dB) | JAX record (TPU): PSNR / SSIM / mAP@.5 |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if "psnr" not in r["modes"].get("render", {}) or "psnr" not in r["modes"].get(
                "render_init", {}):
            continue
        m, ref = r["modes"]["render"], JAX_RECORD.get(r["family"], {})
        res = r["resume"]
        lines.append(
            f"| {r['family']} | {_f(m['psnr'])} | {_f(m['ssim'], 4)} | {_f(m['ap50'], 3)} | "
            f"{_f(m['map'], 3)} | {_f(r['modes']['render_init']['psnr'])} | "
            f"{_f(r['train']['rays_per_sec_median'], 0)} | {res['newest_checkpoint']}, "
            f"{res['bits_equal']}, {_f(res['psnr_drop_db'])} | "
            f"{ref.get('psnr')} / {ref.get('ssim')} / {ref.get('ap50')} |")
    for r in records:
        modes = {k: v for k, v in r.get("modes", {}).items() if "error" not in v}
        if "mani_eval" in modes:
            me, ref = modes["mani_eval"], JAX_RECORD["dmsr"]
            lines += ["", f"mani_eval (translation, label 1, {me['views']} views): PSNR "
                      f"{_f(me['psnr'])}, SSIM {_f(me['ssim'], 4)}, mAP@.5 {_f(me['ap50'], 3)}, "
                      f"mAP@[.5:.95] {_f(me['map'], 3)} (JAX record: PSNR {ref['mani_psnr']}, "
                      f"mAP@.5 {ref['mani_ap50']})"]
        if "mani_demo" in modes:
            md = modes["mani_demo"]
            lines.append(f"mani_demo: {md['frames']} frames, {_f(md['s_per_frame_warm'], 3)} s a "
                         f"frame warm, the first {_f(md['s_first_frame'], 3)} s")
        if "mesh" in modes:
            ms = modes["mesh"]
            lines.append(f"mesh ({ms['overrides']['mesh_grid_dim']}³, level "
                         f"{ms['overrides']['mesh_level']}): "
                         f"{ms['verts']} vertices / {ms['faces']} faces, cleaned "
                         f"{ms['clean_verts']} / {ms['clean_faces']}; host s "
                         + ", ".join(f"{k} {v:.2f}" for k, v in ms["seconds"].items())
                         + f"; peak RSS {ms['peak_rss_gb']:.2f} GB")
        if "long" in r:
            lines += ["", "| 10k bucket | " + " | ".join(r["long"]["rays_per_sec_by_10k"]) + " |",
                      "|---|" + "---|" * len(r["long"]["rays_per_sec_by_10k"]),
                      "| median rays/s | " + " | ".join(f"{v:.0f}" for v in
                                                       r["long"]["rays_per_sec_by_10k"].values()) + " |",
                      "", "| step | PSNR | SSIM | mAP@.5 | mAP@[.5:.95] | JAX record |",
                      "|---|---|---|---|---|---|"]
            for step, e in r["long"]["held_out"].items():
                ref = JAX_RECORD["long"]["by_step"].get(step)
                lines.append(f"| {step} | {_f(e['psnr'])} | {_f(e['ssim'], 4)} | {_f(e['ap50'], 3)} | "
                             f"{_f(e['map'], 3)} | {ref if ref else '—'} |")
            res = r["resume"]
            lines.append(f"\nresume: killed past {r['kill']}, newest checkpoint "
                         f"{res['newest_checkpoint']}, bits equal {res['bits_equal']}, last F_PSNR "
                         f"before {_f(res['last_before_kill']['psnr_fine'])} (step "
                         f"{res['last_before_kill']['step']}), first after "
                         f"{_f(res['first_after_resume']['psnr_fine'])} (step "
                         f"{res['first_after_resume']['step']}); peak device memory "
                         f"{_f(r['train']['peak_device_gb'])} GB")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="all", choices=FAMILIES + ("all",))
    ap.add_argument("--long", action="store_true", help="docs/LONGRUN.md's run instead")
    ap.add_argument("--smoke", action="store_true",
                    help="the smaller cycles of chip_smoke.py phase 18")
    ap.add_argument("--scene", action="append", default=[], metavar="KEY=VALUE",
                    help="a writer argument in place of the cycle's (e.g. n_train=21), for a "
                         "diagnosis; recorded with the scene")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default=os.path.join(REPO, "build", "e2e_cycle"))
    ap.add_argument("--out", default=os.path.join(REPO, "build", "e2e_cycle", "records"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("e2e_cycle: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
            return 1
    card = smi() if args.device == "cuda" else None
    os.makedirs(args.out, exist_ok=True)
    cycles = ([cycle("dmsr", "long")] if args.long else
              [cycle(f, "smoke" if args.smoke else "full")
               for f in (FAMILIES if args.family == "all" else (args.family,))])
    scene = {k: json.loads(v) for k, v in (a.split("=", 1) for a in args.scene)}
    cycles = [dataclasses.replace(c, scene={**c.scene, **scene}) for c in cycles]
    tag = "long" if args.long else "smoke" if args.smoke else "cycle"
    records, failed = [], False
    for c in cycles:
        work = os.path.join(args.work, tag)
        try:
            rec = run_cycle(c, work, args.device)
        except CycleError as e:
            rec = {"family": c.family, "failures": [str(e)]}
        rec["card"] = card
        if args.long and "log_dir" in rec:
            rec["long"] = long_summary(rec)
        records.append(rec)
        failed |= bool(rec["failures"])
        with open(os.path.join(args.out, f"e2e_{tag}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[e2e] {c.family}: {json.dumps(rec)}", flush=True)
        for s in rec.get("suspected_fault", []):
            print(f"[e2e] {c.family}: SUSPECTED FAULT: {s}", flush=True)
    table = markdown([r for r in records if "modes" in r], card)
    with open(os.path.join(args.out, f"e2e_{tag}.md"), "a") as f:
        f.write(table)
    print(table, flush=True)
    for r in records:
        for fmsg in r["failures"]:
            print(f"[e2e] {r['family']}: FAILED: {fmsg}", file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
