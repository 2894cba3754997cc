"""What every cell shares: finding a cell's files by name, the card check,
the guard against JAX in the process, the card's identity and the result
line.  Nothing here imports the program."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # perfbench/
CHECKOUT = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "oryon_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: the process exits non-zero."""


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    path = os.path.join(CHECKOUT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no {path}")
    return read_json(path)


def workload_names() -> List[str]:
    """Every cell that has a file in ``perfbench/workloads/``."""
    return sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "workloads"))
                  if f.endswith(".json"))


def load_cell(name: str) -> Dict:
    """{"workload": the cell's file over its traffic mix's file, "config":
    its configuration's file}.  The mix, ``perfbench/traffic/<traffic>.json``,
    holds the traffic's parameters and names its generator; the cell's file
    holds its configuration, chips, sampling of the check and limits."""
    path = os.path.join(ROOT, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise BenchError(f"no workload {name!r}: cells are {workload_names()}")
    wl = read_json(path)
    mix_path = os.path.join(ROOT, "traffic", f"{wl['traffic']}.json")
    if not os.path.exists(mix_path):
        raise BenchError(f"workload {name!r} names the traffic mix {wl['traffic']!r}, "
                         f"which has no file {mix_path}")
    return {"name": name, "workload": {**read_json(mix_path), **wl},
            "config": read_json(os.path.join(ROOT, "configs", f"{wl['config']}.json"))}


def load_module(path: str, name: str):
    """A module of ``perfbench/`` by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_module(generator: str):
    """A traffic mix's generator, ``perfbench/traffic/<generator>.py``."""
    return importlib.import_module(f"perfbench.traffic.{generator}")


def reference(cfg: dict):
    """A configuration's plain model reference, ``perfbench/reference/<name>.py``
    for its ``"reference"`` key (``model`` without one); the contract such a
    module keeps is in ``perfbench/reference/__init__.py``."""
    name = cfg.get("reference", "model")
    module = f"perfbench.reference.{name}"
    if not isinstance(name, str) or not name.isidentifier():
        raise BenchError(f"reference {name!r} is not a module name")
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise BenchError(f"the configuration names the reference {name!r}, which has no file "
                         f"{os.path.join(ROOT, 'reference', name + '.py')}") from None


def layer_reader(metric: str):
    """The reader of a per-layer metric, ``perfbench/layers/<metric>.py``."""
    path = os.path.join(ROOT, "layers", f"{metric}.py")
    if not os.path.exists(path):
        raise BenchError(f"per-layer metric {metric!r} has no reader {path}")
    return load_module(path, "perfbench_layer_" + metric.replace(".", "_"))


def cell_metrics(cell: str, section: str, bench: dict) -> List[dict]:
    """The metrics of ``section`` ("end_to_end" | "per_layer") that ``cell``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def set_environment() -> None:
    """Before torch is imported: build and kernel caches at fixed paths
    inside the checkout, so that only a cell's first run there builds
    anything, and one intra-op thread, so that the load comes from one
    thread of one process (set-up takes half the time it takes with a
    thread a core, and the window's rate does not move)."""
    base = os.path.join(CHECKOUT, "build", "perfbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(base, sub)
    os.environ.update(USE_FLAX="0", OMP_NUM_THREADS="1", OMP_WAIT_POLICY="PASSIVE")


def jax_modules() -> List[str]:
    """Modules in this process whose top-level name is JAX's or the JAX
    package's, compared whole (``oryon_tpu_torch`` is not ``oryon_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_identity() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA cards are there."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA card: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise BenchError(f"the cell asks for {n} cards, {torch.cuda.device_count()} found")


def emit(result: dict, checks: List[dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result as the last line of standard output,
    with the checks under their own key, last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()

    def finite(v):      # an infinite gap prints as null: the line stays strict JSON
        return v if v is None or math.isfinite(v) else None

    result = dict(result)
    result["checks"] = {c["name"]: {"value": finite(c["value"]), "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(result), flush=True)


def metric(value: Optional[float], unit: str) -> Optional[dict]:
    return None if value is None else {"value": float(value), "unit": unit}
