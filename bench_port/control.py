"""Readings that the checks' limits are set from, on the card.

    python3 -m bench_port.control --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--fault unchanged|half|answer|value|labels]

For each seed, one run of the cell at its own size in this process: the
numbers the checks compare for the program and, beside them, for the
control (the reference put in the program's place, one precision lower:
float8 for the bf16 towers, TF32 for the float32 teacher).  With
``--fault`` the program runs with that fault planted (``faults.py``) and
only its readings are printed.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json

from bench_port import faults, harness
from bench_port.profiling import Patches
from bench_port.run import Context, execute


def readings(workload: str, seed: int, seconds: float, fault=None,
             device="cuda", config=None, traffic=None) -> dict:
    """One run's checked numbers (and the control's, without a fault) of
    ``workload``, or of the given configuration and traffic mix."""
    if config is None or traffic is None:
        cell = harness.cell(workload)
        config = harness.load_json("configs", cell["config"])
        traffic = harness.load_json("traffic", cell["traffic"])
    ctx = Context(seed=seed, seconds=seconds, trace=False, config=config,
                  traffic=traffic, device=device, control=fault is None)
    with Patches() as p:
        if fault is not None:
            for mod, attr, value in faults.patches(ctx.traffic["runner"],
                                                   fault):
                p.set(mod, attr, value)
        out = execute(ctx)
    return {"seed": seed, "fault": fault,
            "correct": all(c.ok for c in out["checks"]),
            "checks": {c.name: c.value for c in out["checks"]},
            "readings": out["record"].get("readings"),
            "control": out["record"].get("control"),
            "worst_leaves": out["record"].get("worst_leaves"),
            "leaf_gaps": out["record"].get("leaf_gaps")}


def main(argv=None) -> None:
    import torch

    parser = argparse.ArgumentParser(prog="bench_port.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        raise SystemExit("bench_port.control: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.fault)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
