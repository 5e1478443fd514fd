"""Run one cell of the benchmark of yoda_tpu_torch once, on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics with the device's busy and window seconds and a breakdown
(``--trace 1``) as the last line of standard output, one JSON object; the
numbers the reference compared, each beside its limit, end standard error
and the result line. Exits non-zero and prints no result without a CUDA
device, or when JAX or the JAX package is loaded once the window closed.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# One process with few threads: the shared host's cores go to the
# scheduler's own threads, not to idle math pools spinning beside them.
for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # Every build and kernel cache at a fixed path inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    from portbench.harness import runner

    out = runner.run_cell(ROOT, bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_process=T_PROCESS)
    line = result_line(out, bool(args.trace))
    found = runner.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def result_line(out: dict, trace: bool) -> dict:
    from portbench.harness.runner import load_module
    from portbench.harness.trace import kernel_time

    run, verdict, cell = out["run"], out["verdict"], out["cell"]
    import torch

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    in_window = [e for e in run.events
                 if e.kind == "add" and not e.node and run.t_start <= e.t < run.t_end]
    departed = sum(verdict.numbers[n][0] for n in ("wrong_node", "infeasible_bind",
                                                      "over_chips"))
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
        "memory_peak_bytes": out["memory_peak"],
        "power_limit": card_power_limit(),
    }
    line = {
        "correct": verdict.correct,
        "attempted": len(in_window),
        "failed": departed,
        "metrics": metrics,
        "device": device,
    }
    notes = []
    if trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
        _secs, records = kernel_time(run.trace, "fleet_eval_kernel")
        notes.append(f"fleet_eval launches {len(run.launches)} traced records {records}")
    line["notes"] = notes + verdict.notes
    line["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in verdict.numbers.items()}
    return line


if __name__ == "__main__":
    sys.exit(main())
