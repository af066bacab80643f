"""One run of one cell: find its files by name, run its driver, read the
per-layer metrics, judge the outputs and print the result's line.

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each compared number
beside its limit. Those numbers also end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
ROOT = pathlib.Path(__file__).resolve().parents[1]


class SpecError(RuntimeError):
    """A name in ``BENCHMARK.json`` finds no file."""


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: object
    arch: object
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list
    root: pathlib.Path


@dataclasses.dataclass
class Context:
    """What a driver gets."""
    seed: int
    seconds: float
    trace: bool
    device: object
    config: dict
    traffic: dict
    arch: object
    t0: float
    fault: str | None = None
    control: bool = False


def _module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise SpecError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _json(path: pathlib.Path, name: str) -> dict:
    if not path.is_file():
        raise SpecError(f"no file {path} for {name!r}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    """Every cell reports a metric, unless it lists its cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = _json(root / "BENCHMARK.json", "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r}; known: {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[work["config"]]["file"], work["config"])
    here = root / "portbench"
    traffic = _json(here / "traffic" / f"{work['traffic']}.json",
                    work["traffic"])
    return Cell(
        name=name, chips=work["chips"], config=config, traffic=traffic,
        limits=_json(here / "limits" / f"{name}.json", name),
        driver=_module(here / "drivers" / f"{traffic['driver']}.py",
                       traffic["driver"]),
        arch=_module(here / "reference" / f"{config['arch']}.py",
                     config["arch"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, fault: str | None = None,
             control: bool = False) -> tuple[dict, object]:
    """Run ``cell`` once on ``device`` → the result's object and the
    driver's outcome (the caller has looked for the chips)."""
    ctx = Context(seed=seed, seconds=seconds, trace=trace, device=device,
                  config=cell.config, traffic=cell.traffic, arch=cell.arch,
                  t0=t0, fault=fault, control=control)
    out = cell.driver.run(ctx)
    metrics, missing = {}, []
    if trace:
        reading = dict(out.reading, trace=out.trace)
        for m in cell.per_layer:
            value = _module(cell.root / "portbench" / "metrics" /
                            f"{m['name']}.py", m["name"]).read(reading)
            if value is None:
                missing.append(m["name"])
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = out.end_to_end.get(m["name"])
            if value is None:
                missing.append(m["name"])
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = _device(device, cell.chips, out.memory_peak_bytes)
    result = {"correct": False, "attempted": out.attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and out.trace is not None:
        from portbench import devtrace
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.wall_s
        result["breakdown"] = devtrace.breakdown(out.trace)
    from portbench import checks
    limits = cell.limits["limits"]
    result["correct"] = checks.judge(out.numbers, limits)
    result["checks"] = {k: {"value": out.numbers[k], "limit": lim}
                        for k, lim in limits.items()}
    print(f"portbench: missing {missing}; where {out.where}; numbers "
          f"{out.numbers}", file=sys.stderr, flush=True)
    return result, out


def _device(device, chips: int, peak: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict) -> None:
    """Standard error's last lines and standard output's last line."""
    for key, check in result["checks"].items():
        print(f"{key} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line = {k: v for k, v in result.items() if k != "checks"}
    line["checks"] = result["checks"]     # last, as the contract asks
    print(json.dumps(line), flush=True)


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seconds <= 0:
        parser.error("--seconds must be positive")
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    emit(result)
    return 0
