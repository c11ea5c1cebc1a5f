"""Which kernels of two checkouts of dmnerf_tpu_torch compile to the same SASS, on a
machine with nvcc (no card needed):

    python3 scripts/sass_diff_torch.py --base DIR [--repo DIR] [--names a,b,...] [--out FILE]

Each named source of ``<checkout>/dmnerf_tpu_torch/kernels/csrc`` (default: the forward
template's K1, K3, K5, the fused render passes and the head probes) is built by nvcc with
the flags of this checkout's ``kernels/runtime.NVCC_FLAGS`` into a shared library under
``<repo>/build/sass_diff/``, as the runtime builds it; ``cuobjdump -sass`` of each library
is split into its kernels, and each kernel's instructions in ``--repo`` (default: this
checkout) are compared with those of the same kernel in ``--base``. A kernel is named by
its demangled name with internal namespaces left out (``cu++filt``), so that two builds of
one template instance match. One line a kernel (``same``, ``differs``, or the side it is
missing on, with its instruction counts, and for ``differs`` its first differing lines);
the last line of stdout is one JSON object with all of it, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("fused_mlp_fwd", "fused_mlp_fwd_kpe", "fused_mlp_fwd_pe", "fused_render", "head512",
         "heads_fused")


def _tool(nvcc: str, name: str) -> str:
    return os.path.join(os.path.dirname(nvcc), name)


def build(nvcc: str, flags, checkout: str, name: str, dst: str) -> str:
    """``checkout``'s csrc/<name>.cu built into ``dst``/<name>.so; returns its path."""
    os.makedirs(dst, exist_ok=True)
    so = os.path.join(dst, f"{name}.so")
    src = os.path.join(checkout, "dmnerf_tpu_torch", "kernels", "csrc", f"{name}.cu")
    out = subprocess.run([nvcc, *flags, "-o", so, src], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src} exited {out.returncode}:\n{out.stdout}{out.stderr}")
    return so


def kernels(nvcc: str, so: str) -> dict:
    """{kernel name: its SASS instruction lines} of the library ``so``."""
    sass = subprocess.run([_tool(nvcc, "cuobjdump"), "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    by_mangled, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            by_mangled[fn] = []
        elif fn is not None and re.search(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]{16} \*/", line):
            by_mangled[fn].append(line.strip())   # an instruction, or its encoding's second half
    names = subprocess.run([_tool(nvcc, "cu++filt")], input="\n".join(by_mangled),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    strip = re.compile(r"\(anonymous namespace\)::|_INTERNAL_\w*?::")
    return {strip.sub("", dm): lines for dm, lines in zip(names, by_mangled.values())}


def _count(lines) -> int:
    return sum(bool(re.match(r"/\*[0-9a-f]{4,}\*/", x)) for x in lines or [])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="the checkout compared against")
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--names", default=",".join(NAMES))
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    from dmnerf_tpu_torch.kernels import runtime

    nvcc = runtime._nvcc()
    names = [n for n in a.names.split(",") if n]
    work = os.path.join(os.path.abspath(a.repo), "build", "sass_diff")
    sides = {"base": os.path.abspath(a.base), "repo": os.path.abspath(a.repo)}
    jobs = [(side, name) for side in sides for name in names]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(nvcc, runtime.NVCC_FLAGS, sides[j[0]], j[1],
                                                       os.path.join(work, j[0])), jobs)))
    res = {"base": sides["base"], "repo": sides["repo"], "flags": runtime.NVCC_FLAGS, "libs": {}}
    for name in names:
        base, repo = kernels(nvcc, libs[("base", name)]), kernels(nvcc, libs[("repo", name)])
        rows = {}
        for k in sorted(set(base) | set(repo)):
            b, r = base.get(k), repo.get(k)
            verdict = ("only in repo" if b is None else "only in base" if r is None
                       else "same" if b == r else "differs")
            nb, nr = _count(b), _count(r)
            rows[k] = dict(verdict=verdict, base_instructions=nb, repo_instructions=nr)
            if verdict == "differs":   # the first lines that differ, base then repo
                rows[k]["first_differences"] = [(x, y) for x, y in zip(b, r) if x != y][:6]
            print(f"[sass] {name}: {verdict}: {k} ({nb} / {nr} instructions)", flush=True)
            for x, y in rows[k].get("first_differences", []):
                print(f"[sass]   base {x}\n[sass]   repo {y}", flush=True)
        res["libs"][name] = rows
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
