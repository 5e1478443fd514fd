"""The control of ``correct``: run a cell with each evaluation's per-node
reservations and claims uploaded in int16 (``--control int16``; the
configuration states exact int32 arithmetic), and the same cell as the
program runs it, on the same seeds, and print each run's compared
numbers.

    python3 portbench/tools/control.py --workload batch5k.singles-backlog \\
        --seeds 11,12,13 --seconds 20 [--sound]

Each number's limit lies between the sound runs' largest reading and the
control's smallest. This tool is not run by the benchmark."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--control", default="int16", choices=sorted(runner.CONTROLS))
    ap.add_argument("--sound", action="store_true", help="also run the program as it is")
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in [int(s) for s in args.seeds.split(",")]:
        for control in ((args.control, None) if args.sound else (args.control,)):
            out = runner.run_cell(ROOT, bench, args.workload, seed, args.seconds, False,
                                  t_process=time.monotonic(), control=control)
            v = out["verdict"]
            print(json.dumps(dict(seed=seed, control=control, correct=v.correct,
                                  numbers={k: n[0] for k, n in v.numbers.items()},
                                  notes=v.notes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
