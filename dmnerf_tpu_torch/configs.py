"""Frozen, explicit configuration.

The same fields, text format and aliases as ``dmnerf_tpu/configs.py`` so every file
under ``configs/`` means the same thing to both packages. The reference's config
files are ``key = value`` lines plus bare flags; the released vocabulary drift is
accepted: ``over_penalize`` == ``penalize``, ``editor_val`` == ``mani_eval``,
``editor_mode`` == ``mani_mode``, ``editor_demo`` == ``mani_demo``.

In this package ``use_pallas`` selects the hand-written Hopper kernels for the point
query, and ``pallas_pe_mode`` picks the kernel pair as it picks the Pallas pair in
the JAX package: ``None`` or ``'kernel_t'`` the per-ray viewdir table kernels (K1
forward, K2 backward), ``'kernel'`` the per-point in-kernel embedding kernels (K3,
K4), ``'outside'`` the embedding kernel (K7) and the kernels over precomputed
embeddings (K5 forward, K6 backward); any other value is refused here. The tile knobs
(``pallas_tile_fwd``, ``pallas_tile_bwd``) size the TPU's grid tiles and the
JAX-only switches (``data_axis``, ``multihost``) are parsed so that config files stay
interchangeable, and have no effect here. ``steps_per_dispatch`` packs whole train
steps into one dispatch, one CUDA graph replay on the card (``train.make_packed_steps``).
``debug_nans``
makes every train step check its losses and gradients for finiteness and raise
``FloatingPointError`` at the first non-finite one (``render.trainstep.check_finite``);
``profile_dir`` traces the steps ``profile_start`` ... ``profile_start +
profile_steps - 1`` with ``torch.profiler`` (``train.profile_trace``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

PE_MODES = (None, "kernel_t", "kernel", "outside")


@dataclasses.dataclass(frozen=True)
class Config:
    # experiment / paths
    expname: str = "study"
    basedir: str = "./logs"
    datadir: str = "./data/dmsr/study"
    log_time: Optional[str] = None
    dataset_type: str = "dmsr"  # dmsr | replica | scannet

    # model
    netdepth: int = 8
    netwidth: int = 256
    skips: Tuple[int, ...] = (4,)
    i_embed: int = 0          # 0 = positional encoding, -1 = identity
    multires: int = 10        # xyz frequencies
    multires_views: int = 4   # view-dir frequencies

    # sampling
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0

    # training
    N_train: int = 4096
    lrate: float = 5e-4
    lrate_decay: int = 500    # exp decay horizon in thousands of steps
    N_iters: int = 500001
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    seed: int = 0

    # inference / chunking
    N_test: int = 2048
    render_factor: int = 0    # declared by the reference, read by no code path

    # dataset options
    testskip: int = 10
    resize: bool = False
    white_bkgd: bool = False
    near: float = 0.0
    far: float = 1.0
    crop_width: Optional[int] = None
    crop_height: Optional[int] = None

    # logging intervals
    i_print: int = 100
    i_img: int = 500
    i_save: int = 10000
    i_test: int = 50000
    i_video: int = 50000

    # object-field / instance options
    ins_num: int = 32          # resolved from the dataset palette at load time
    weakly_mode: str = "weakly_ins"
    weakly_value: float = 1.0
    penalize: bool = False     # reference flag name: over_penalize
    tolerance: float = 0.0
    deta_w: float = 0.0

    # manipulation
    mani_demo: bool = False
    mani_eval: bool = False
    mani_mode: str = "rotation"   # translation | rotation | scale | multi
    views: int = 720
    target_label: Optional[int] = None

    # mesh extraction
    mesh_grid_dim: int = 256
    mesh_level: float = 0.45

    # eval-mode switches
    render: bool = False
    render_test: bool = False
    mesh: bool = False
    # ft_path: an explicit checkpoint (a checkpoint file, a checkpoints dir or a
    # run dir); a path that names no checkpoint is a loud error
    ft_path: Optional[str] = None
    no_reload: bool = False

    # additions of the JAX package, kept for config-file compatibility
    precision: str = "float32"
    use_pallas: bool = True       # here: the hand-written Hopper point-query kernel
    pallas_pe_mode: Optional[str] = None   # None | 'kernel_t' | 'kernel' | 'outside'
    pallas_tile_fwd: Optional[int] = None  # no effect in this package
    pallas_tile_bwd: Optional[int] = None  # no effect in this package
    data_axis: int = 1
    checkpoint_every: int = 10000
    resume: bool = True
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 5
    multihost: bool = False
    steps_per_dispatch: int = 1

    def __post_init__(self):
        if self.pallas_pe_mode not in PE_MODES:
            raise ValueError(f"pallas_pe_mode must be one of {PE_MODES}, got "
                             f"{self.pallas_pe_mode!r}")
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}")
        # a zero-width penalizer Gaussian is exp(-0/0) = NaN: refuse it at config time
        if self.penalize and (self.deta_w <= 0.0 or self.tolerance <= 0.0):
            raise ValueError(
                "penalize/over_penalize requires tolerance > 0 and deta_w > 0 "
                f"(got tolerance={self.tolerance}, deta_w={self.deta_w}); the reference "
                "configs set both to 0.05 (configs/train/dmsr/study.txt:18-19)"
            )

    @property
    def log_dir(self) -> str:
        t = self.log_time if self.log_time is not None else "run"
        return os.path.join(self.basedir, self.expname, t)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_ALIASES = {
    "over_penalize": "penalize",
    "editor_val": "mani_eval",
    "editor_mode": "mani_mode",
    "editor_demo": "mani_demo",
}

_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(field: dataclasses.Field, raw: str):
    raw = raw.strip()
    ty = field.type
    if ty.startswith("Optional["):
        if raw.lower() in ("none", ""):
            return None
        ty = ty[len("Optional["):-1]
    if ty == "int":
        return int(raw)
    if ty == "float":
        return float(raw)
    if ty == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if ty.startswith("Tuple"):
        return tuple(int(x) for x in raw.replace(",", " ").split())
    return raw


def parse_config_text(text: str, base: Optional[Config] = None) -> Config:
    """Parse a reference-style ``key = value`` config file into a Config.

    Bare lines (no ``=``) are boolean flags set to True. Unknown keys are ignored,
    with a warning that names the closest field."""
    cfg = base if base is not None else Config()
    updates = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" in line:
            key, raw = line.split("=", 1)
            key = key.strip()
        else:
            key, raw = line, "true"
        key = _ALIASES.get(key, key)
        if key not in _FIELDS:
            import difflib
            import warnings

            close = difflib.get_close_matches(key, _FIELDS, n=1)
            hint = f" (did you mean '{close[0]}'?)" if close else ""
            warnings.warn(f"config: ignoring unknown key '{key}'{hint}", stacklevel=2)
            continue
        updates[key] = _coerce(_FIELDS[key], raw)
    return cfg.replace(**updates)


def load_config(path: str, base: Optional[Config] = None, **overrides) -> Config:
    with open(path) as f:
        cfg = parse_config_text(f.read(), base)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def parse_cli(argv) -> Config:
    """``--config FILE`` plus ``key=value`` / ``--flag`` overrides, as the JAX
    command lines take them."""
    cfg_path = None
    overrides = {}
    it = iter(argv)
    for a in it:
        if a == "--config":
            cfg_path = next(it)
        elif "=" in a:
            k, v = a.split("=", 1)
            overrides[k.lstrip("-")] = v
        elif a.startswith("--"):
            overrides[a[2:]] = "true"
    cfg = load_config(cfg_path) if cfg_path else Config()
    if overrides:
        cfg = parse_config_text("\n".join(f"{k} = {v}" for k, v in overrides.items()), cfg)
    return cfg


def dump_config(cfg: Config, log_dir: str) -> None:
    """Snapshot the resolved config as ``args.txt``."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.txt"), "w") as f:
        for field in sorted(_FIELDS):
            f.write(f"{field} = {getattr(cfg, field)}\n")
