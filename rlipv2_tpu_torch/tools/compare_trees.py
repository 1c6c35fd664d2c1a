"""Profiling turns of two checkouts on one GPU: parent, change, change, parent.

    python -m rlipv2_tpu_torch.tools.compare_trees PARENT_DIR [--out DIR]
        [--runs forward_r50 forward_swin_l forward_r50_int8 train]

PARENT_DIR is a second checkout of the repository, for example an earlier
commit unpacked with `git archive <commit> | tar -x -C build/parent`; the
change is the checkout this module is imported from. Each run named in
`--runs` (`forward_r50`: `profile_forward --model r50`, `forward_swin_l`:
`profile_forward --model swin_l`, `forward_r50_int8`: `profile_forward
--model r50 --int8 msda`, `train`: `profile_train`) goes four
times, each in a fresh process from the root of one tree, in the order
parent, change, change, parent. Each process's output goes to
OUT/<run>_<turn>_<tree>.log (OUT defaults to build/compare), and its
summary lines (the card and power limit, the p50 lines, the profiled device
time and the families) are printed under a heading that names the run, the
turn and the tree. Both
trees build their kernels into their own `build/kernels/`. Needs a CUDA
device; exits non-zero if any process does.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

RUNS = {
    "forward_r50": ["rlipv2_tpu_torch.tools.profile_forward", "--model", "r50"],
    "forward_swin_l": ["rlipv2_tpu_torch.tools.profile_forward", "--model", "swin_l"],
    "forward_r50_int8": ["rlipv2_tpu_torch.tools.profile_forward", "--model", "r50", "--int8", "msda"],
    "train": ["rlipv2_tpu_torch.tools.profile_train"],
}
TURNS = ("parent", "change", "change", "parent")
SUMMARY_PREFIXES = ("NVIDIA", "kernel ", "plain ", "train ", "profiled", "families")
RUN_TIMEOUT_S = 900


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent", type=Path)
    parser.add_argument("--out", type=Path, default=Path("build/compare"))
    parser.add_argument("--runs", nargs="+", choices=tuple(RUNS), default=list(RUNS))
    args = parser.parse_args()
    trees = {"parent": args.parent.resolve(), "change": Path(__file__).resolve().parents[2]}
    for tree in trees.values():
        if not (tree / "rlipv2_tpu_torch").is_dir():
            raise SystemExit(f"{tree} is not a checkout of the repository")
    args.out.mkdir(parents=True, exist_ok=True)
    failed = []
    for run in args.runs:
        for turn, who in enumerate(TURNS):
            log = args.out.resolve() / f"{run}_{turn}_{who}.log"
            # each tree imports only its own package
            env = {**os.environ, "PYTHONPATH": str(trees[who])}
            with open(log, "w") as f:
                rc = subprocess.run([sys.executable, "-m", *RUNS[run]], cwd=trees[who], env=env,
                                    stdout=f, stderr=subprocess.STDOUT, timeout=RUN_TIMEOUT_S).returncode
            print(f"== {run} turn {turn} {who} (exit {rc}, {log.name})", flush=True)
            for line in log.read_text().splitlines():
                if line.startswith(SUMMARY_PREFIXES):
                    print(line[:900], flush=True)
            if rc != 0:
                failed.append(log.name)
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
