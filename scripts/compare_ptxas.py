#!/usr/bin/env python3
"""Build the kernel library of this tree and of another one, and compare
what ``ptxas -v`` says of every kernel entry: registers, barriers, stack
frame, spill stores and loads, shared and constant memory.

    python3 scripts/compare_ptxas.py --parent build/parent/src \
        --out chiprun_out/ptxas.json          # needs nvcc (the card's host)

Each tree's ``repro_torch.kernels._build.build()`` runs in its own
process, each into the ``build/ptxas_compare/`` of its own tree.
Entry names are compared with the anonymous namespace's hash of the
source path stripped, since it differs between checkouts.  Prints one
line an entry whose figures differ, the entries only one tree has, and
exits 1 if an entry of the other tree differs or is missing here.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.BUILD_DIR = _build.BUILD_DIR.parent / 'ptxas_compare'; "
         "import shutil; shutil.rmtree(_build.BUILD_DIR, ignore_errors=True); "
         "_build.build(); sys.stdout.write(_build.build_log)")
ENTRY = re.compile(r"Compiling entry function '([^']+)'")
PROPS = re.compile(r"Function properties for (\S+)")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers(.*)")


def normalize(name: str) -> str:
    """The entry's mangled name without the per-checkout path hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)


def entries(log: str) -> dict:
    """``{entry: {registers, used, frame, spill_stores, spill_loads}}``
    from one build's compiler output."""
    out, cur, props = {}, None, None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            cur = normalize(m.group(1))
            out.setdefault(cur, {})
            continue
        m = PROPS.search(line)
        if m:
            props = normalize(m.group(1))
            continue
        m = FRAME.search(line)
        if m and props in out:
            out[props].update(frame=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = USED.search(line)
        if m and cur is not None:
            out[cur].update(registers=int(m.group(1)),
                            used=m.group(2).strip(" ,"))
    return out


def build_log(src: Path) -> str:
    p = subprocess.run([sys.executable, "-c", BUILD, str(src)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise SystemExit(f"build of {src} failed:\n{p.stderr[-4000:]}")
    return p.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other tree's src directory")
    ap.add_argument("--out", help="write both trees' entries here as JSON")
    args = ap.parse_args(argv)
    mine = entries(build_log(ROOT / "src"))
    theirs = entries(build_log(Path(args.parent).resolve()))
    bad = 0
    for name in sorted(theirs):
        if name not in mine:
            print(f"missing here: {name}")
            bad += 1
        elif mine[name] != theirs[name]:
            print(f"differs: {name}: {theirs[name]} -> {mine[name]}")
            bad += 1
    new = sorted(set(mine) - set(theirs))
    for name in new:
        print(f"new here: {name}: {mine[name]}")
    print(f"{len(theirs)} entries in the other tree, {len(theirs) - bad} "
          f"equal here; {len(new)} new")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"here": mine, "other": theirs}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
