"""Everything of a cell, found by name: its entry in ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic mix (``mixes/<traffic>.json``) and that mix's
driver (``drivers/<kind>.py``), the readers of its metrics (``e2e/<name>.py``,
``metrics/<name>.py``), the kernel roles (every ``roles/*.json``; files that name the same
role add their kernels to it) and its limits (``limits/<cell>.json``). A new cell, mix,
metric or role is a new file and an entry; no file is edited.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _for_cell(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: Optional[dict] = None, here: Path = HERE) -> dict:
    """The cell ``name``: {workload, conf, mix, end_to_end, per_layer, limits}, each
    metric entry as ``BENCHMARK.json`` has it."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ()) or
                 ("workloads" not in m and m["moves"] in reported)]
    limits_path = here / "limits" / f"{name}.json"
    return {"workload": w,
            "conf": load_json(here / "configs" / f"{w['config']}.json"),
            "mix": load_json(here / "mixes" / f"{w['traffic']}.json"),
            "end_to_end": e2e, "per_layer": per_layer,
            "limits": load_json(limits_path) if limits_path.exists() else {}}


def driver(kind: str):
    """The ``Driver`` class of a mix kind."""
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def reader(folder: str, name: str, here: Path = HERE):
    """The ``read`` function of ``<folder>/<name>.py`` (a name may hold dots)."""
    path = here / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}._{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def roles(here: Path = HERE) -> Dict[str, dict]:
    """role -> {"kernels": [name patterns], "work": the work its roofline counts, or None}."""
    out: Dict[str, dict] = {}
    for path in sorted((here / "roles").glob("*.json")):
        r = load_json(path)
        role = out.setdefault(r["role"], {"kernels": [], "work": None})
        role["kernels"] += r["kernels"]
        if r.get("work"):
            role["work"] = r["work"]
    return out


def limit_names(limits: dict) -> List[str]:
    return [k for k in limits if not k.startswith("_")]
