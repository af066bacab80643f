"""The readings that a cell's comparison limits are set from, on the chip at
the cell's own size: the program against the reference on many seeds, the
control (the reference in float8 in the program's place) and the faults
planted in the program (``drivers/dpsgd_train.FAULTS``), with no measured
window, several seeds in one process. From the root of a checkout:

    PYTHONPATH=src python3 -m portbench.calibrate --workload <cell> \
        --seeds 1,2,3 --control 1,2 --fault half_batch:1,2 \
        --fault no_gossip:1,2 --out chiprun_out/calibration.jsonl

One JSON line a run, with every number ``checks.gaps`` reads and whether
the cell's limits (``limits/<cell>.json`` as it stands) find the program's
run ``correct`` and, for the control, ``control_correct``. A benchmark run
never runs this."""

import argparse
import json
import sys
import time

from portbench import checks, harness


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control", type=_seeds, default=[])
    parser.add_argument("--fault", action="append", default=[],
                        help="name:seed,seed,…")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    limits = cell.limits["limits"]
    runs = [(s, None) for s in args.seeds]
    for spec in args.fault:
        name, seeds = spec.split(":")
        runs += [(s, name) for s in _seeds(seeds)]
    for seed, fault in runs:
        t0 = time.perf_counter()
        result, out = harness.run_cell(
            cell, seed, 0.0, False, device, t0, fault=fault,
            control=fault is None and seed in args.control)
        line = {"cell": cell.name, "seed": seed, "fault": fault,
                "correct": result["correct"], "numbers": out.numbers,
                "control": out.control,
                "control_correct": (None if out.control is None
                                    else checks.judge(out.control, limits)),
                "where": out.where, "loss": out.prog["loss"],
                "ref_loss": out.ref["loss"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del result, out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
