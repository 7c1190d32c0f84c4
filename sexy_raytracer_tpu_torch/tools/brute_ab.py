"""A/B of kernel 9 against a parent commit in one call:
``tools.find_split brute --quick`` in the parent's tree, in this
checkout's and in copies of it with other constants in
``csrc/brute.cu``, one process each, in the order of ``TREES`` and back
(A B ... B A).

    python -m sexy_raytracer_tpu_torch.tools.brute_ab prepare PARENT
    python -m sexy_raytracer_tpu_torch.tools.brute_ab run [--out DIR]

``prepare`` (needs git, no card) writes ``build/ab/<tree>/`` for each
entry of ``TREES``: the parent from ``git archive PARENT`` of the
package, with this checkout's ``tools/find_split.py`` copied in (its
brute mode uses only what ``ops/brute.py`` has had since its first
version); each other tree a copy of this checkout's package with the
entry's constants set in ``csrc/brute.cu``. ``run`` (on the card) runs
the brute mode in each tree in turn, writes each run's rows to
``DIR/<turn>_<tree>.json`` and prints one line per (tree, case): ms by
CUDA events and device ms by the profiler, slices, blocks and the output
digest.
"""

from __future__ import annotations

import argparse
import io
import json
import re
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

PKG = "sexy_raytracer_tpu_torch"
ROOT = Path(__file__).resolve().parents[2]
TREES_DIR = ROOT / "build" / "ab"
# (tree, constants of csrc/brute.cu): the parent (None), the committed
# kernel ({}) and the committed kernel with a one-stage ring and with one
# ray a lane as well
TREES = [
    ("parent", None),
    ("one_stage", dict(STAGES=1)),
    ("one_stage_one_ray", dict(STAGES=1, RPT=1)),
    ("committed", {}),
]


def _copy_package(dst):
    shutil.copytree(ROOT / PKG, dst / PKG, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc", "build"))


def prepare(parent):
    """Write the trees of ``TREES`` under build/ab/."""
    if TREES_DIR.exists():
        shutil.rmtree(TREES_DIR)
    for name, consts in TREES:
        dst = TREES_DIR / name
        dst.mkdir(parents=True)
        if consts is None:
            tar = subprocess.run(["git", "archive", parent, PKG], cwd=ROOT,
                                 capture_output=True, check=True).stdout
            with tarfile.open(fileobj=io.BytesIO(tar)) as t:
                t.extractall(dst, filter="data")
            shutil.copy(ROOT / PKG / "tools" / "find_split.py",
                        dst / PKG / "tools" / "find_split.py")
            continue
        _copy_package(dst)
        src = dst / PKG / "csrc" / "brute.cu"
        text = src.read_text()
        for const, value in consts.items():
            text, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;",
                              rf"\g<1>{value};", text)
            if n != 1:
                raise ValueError(f"{const}: not one constant in brute.cu")
        src.write_text(text)
        print(f"{name}: {consts}", flush=True)


def run(out):
    """The brute mode in each tree of ``TREES``, A B ... B A."""
    out.mkdir(parents=True, exist_ok=True)
    for turn, (name, _) in enumerate(TREES + TREES[::-1]):
        path = out / f"{turn:02d}_{name}.json"
        subprocess.run([sys.executable, "-m", f"{PKG}.tools.find_split",
                        "brute", "--quick", "--out", str(path)],
                       cwd=TREES_DIR / name, check=True,
                       stdout=subprocess.DEVNULL)
        result = json.loads(path.read_text())
        for row in result["rows"]:
            print(json.dumps(dict(
                turn=turn, tree=name, case=row["case"],
                slices=row.get("slices"), blocks=row.get("blocks"),
                ms=row["ms"], device_ms=row["device_ms"],
                out_sha=row["out_sha"], device=result["device"])),
                flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("parent", help="the parent commit")
    r = sub.add_parser("run")
    r.add_argument("--out", default=str(ROOT / "build" / "brute_ab_out"))
    args = ap.parse_args(argv)
    if args.cmd == "prepare":
        prepare(args.parent)
    else:
        run(Path(args.out).resolve())


if __name__ == "__main__":
    main()
