"""Run chosen ``chip_smoke.py`` phases of several checkouts in turns on one
card, so that two versions of a kernel are compared on the same card and
power limit.

    git archive <parent> | tar -x -C build/parent   # a checkout to compare
    python3 scripts/compare_turns.py --tree parent=build/parent --tree change=. \\
        --order parent,change,change,parent --phases flash_attention,serve \\
        --out build/turns.txt

Each turn is a fresh process in its checkout's root: it builds that
checkout's kernels from its own sources (``chip_smoke.phase_build``) and
then runs each phase (``chip_smoke.phase_<name>``), with TF32 off as
``chip_smoke.main`` sets it.  Every line a turn prints is echoed with the
turn's number and label in front, and, with ``--out``, all of them are
written to that file after each turn.  Needs a card; a turn that fails
stops the run with its exit code.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = """
import sys
import torch
if not torch.cuda.is_available():
    sys.exit("compare_turns: CUDA is not available")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
chip_smoke.phase_build()
for name in sys.argv[1:]:
    getattr(chip_smoke, "phase_" + name)()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="LABEL=DIR",
                    help="a checkout holding chip_smoke.py and src/ (repeatable)")
    ap.add_argument("--order", required=True, help="labels in turn order, comma-separated")
    ap.add_argument("--phases", required=True,
                    help="chip_smoke phase names, comma-separated (e.g. flash_attention,serve)")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a turn")
    ap.add_argument("--out", type=Path, help="file that collects every turn's lines")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    phases = args.phases.split(",")
    lines = []
    for i, label in enumerate(args.order.split(","), 1):
        tree = (ROOT / trees[label]).resolve()
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        r = subprocess.run([sys.executable, "-c", TURN, *phases], cwd=tree, env=env,
                           capture_output=True, text=True, timeout=args.timeout)
        for line in r.stdout.splitlines():
            lines.append(f"[turn {i} {label}] {line}")
            print(lines[-1], flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("\n".join(lines) + "\n")
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr, flush=True)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
