"""Run one cell of the port's benchmark and print its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (load, weights from the seed, the inputs, warm-up of every shape
the window uses, and the first steps of the window's own call where the
cell has them) is timed as ``setup_s``; then the cell's traffic runs for
``--seconds``, and the checks compare what that window computed with
the plain reference of ``bench_port/reference/``.  With ``--trace 0`` the
line's metrics are the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from stage timers and a profiler window.  The
last lines of standard error, and the result line's ``checks``, give each
number compared beside its limit.  The exit code is not 0, and no result
is printed, when there is no CUDA device (or fewer than the cell asks
for), when the program is missing, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time

from bench_port import harness, profiling


@dataclasses.dataclass
class Context:
    """What a runner gets: the seed, the window, the cell's configuration
    and traffic mix (tests pass them cut to CPU sizes), the device, and
    whether to read the control beside the program."""

    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    device: str = "cuda"
    control: bool = False


def fail(msg: str) -> None:
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def execute(ctx: Context, metric_names=()) -> dict:
    """Set-up, window and checks of one run; returns the result's fields
    (without the device) and the record the metrics were read from."""
    import torch

    runner = importlib.import_module(
        f"bench_port.runners.{ctx.traffic['runner']}")
    t0 = time.perf_counter()
    if ctx.trace:
        profiling.warm_up()
    state = runner.setup(ctx)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    set_up = time.perf_counter()
    record = runner.window(state, ctx)
    # a runner whose first steps run inside the window's own call opens
    # the window after them, and says when
    record["setup_s"] = record.pop("opened_at", set_up) - t0
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if ctx.device == "cuda" else 0)
    checks = runner.check(state, ctx, record)
    del state
    gc.collect()
    metrics = {}
    for m in metric_names:
        value = harness.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"record": record, "checks": checks, "metrics": metrics}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="bench_port.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    harness.set_cache_dirs()
    cell = harness.cell(args.workload)
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is missing: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['chips']} CUDA devices needed, "
             f"{torch.cuda.device_count()} present")
    if not (harness.ROOT / "dream_go_torch").is_dir() \
            or importlib.util.find_spec("dream_go_torch") is None:
        fail("the program (dream_go_torch) is not in this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx = Context(seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace),
                  config=harness.load_json("configs", cell["config"]),
                  traffic=harness.load_json("traffic", cell["traffic"]))
    out = execute(ctx, harness.metrics_of(cell["name"], ctx.trace))
    record, checks = out["record"], out["checks"]

    found = harness.loaded_forbidden()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": all(c.ok for c in checks),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": out["metrics"], "device": device}
    profile = record.get("profile")
    if ctx.trace and profile:
        device["busy_s"] = profile["busy_s"]
        device["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
