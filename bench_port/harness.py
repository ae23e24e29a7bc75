"""What every cell shares: the manifest, the cell's files, the statistics,
the result line and the checks that a run loads no JAX.

A cell is found by name.  ``BENCHMARK.json`` names its configuration and
its traffic mix; the configuration is ``bench_port/configs/<config>.json``,
the mix ``bench_port/traffic/<traffic>.json``, whose ``runner`` key names
the module of ``bench_port/runners/`` that runs it, and every metric is
read by ``bench_port/metrics/<metric>.py``.  A cell, a mix or a metric is
added by adding files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: top-level modules that no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "dream_go_tpu")
#: the published peaks of one NVIDIA H100 SXM (data sheet, dense rates)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"bench_port: no workload named {name!r}")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def metrics_of(cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (``trace`` on): those that list the cell, or list no cells."""
    m = manifest()
    out = []
    for metric in m["per_layer" if trace else "end_to_end"]:
        cells = metric.get("workloads")
        if cells is None or cell_name in cells:
            out.append(metric)
    return out


def reader(metric_name: str):
    """The ``read(record)`` function of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def input_files(spec: list[dict]) -> list[Path]:
    """The files a traffic mix reads, each checked against the digest the
    mix records, so that the inputs cannot change under the benchmark."""
    out = []
    for item in spec:
        path = ROOT / item["path"]
        if sha256(path) != item["sha256"]:
            raise SystemExit(f"bench_port: {item['path']} differs from the "
                             f"file the traffic mix was defined on")
        out.append(path)
    return out


# ---------------------------------------------------------------------------
# statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, linearly interpolated
    between the two nearest ranks (NumPy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# the run's record and result


@dataclasses.dataclass
class Check:
    """One number compared: the run is correct when ``value`` is at most
    ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(numbers: dict, limits: dict, record: dict) -> list[Check]:
    """The numbers the cell compares (those its traffic mix gives a limit)
    as checks; the others go to ``record["readings"]``, reported and not
    compared."""
    record["readings"] = {k: v for k, v in numbers.items()
                          if k not in limits}
    return [Check(k, numbers[k], limits[k]) for k in limits]


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def cache_dirs() -> dict:
    """Fixed directories inside the checkout for every build and kernel
    cache, so that only a cell's first run in a checkout builds."""
    build = ROOT / "build"
    return {"DG_TORCH_BUILD_DIR": str(build / "kernels"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache")}


def set_cache_dirs() -> None:
    for k, v in cache_dirs().items():
        os.environ[k] = v
