"""What every cell's run shares: the manifest and the files it names, the
caches inside the checkout, the card, the import check, the program's
configuration, and the result's lines.

A cell is found by name: `BENCHMARK.json` gives its configuration, its
traffic and its metrics; `configs/<config>.json` the configuration;
`traffic/<traffic>.json` the mix, whose `generator` names
`generators/<generator>.py`; `limits/<cell>.json` the limits of the
numbers that decide `correct`; `metrics/<metric>.py` each per-layer
metric's reader. Adding a cell or a metric adds files; none is edited.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "htd_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# -- manifest ------------------------------------------------------------------


def check_manifest(m: dict) -> None:
    """Raise ValueError where BENCHMARK.json breaks the naming rules the
    harness relies on (names, units, `better`, `source`, cross-references)."""
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(m) != keys:
        raise ValueError(f"BENCHMARK.json keys {sorted(m)} != {sorted(keys)}")
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            if not NAME.match(e["name"]):
                raise ValueError(f"bad name {e['name']!r} in {group}")
            if (group, e["name"]) in names:
                raise ValueError(f"duplicate name {e['name']!r} in {group}")
            names.add((group, e["name"]))
    configs = {c["name"] for c in m["configs"]}
    cells = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        if w["config"] not in configs or not NAME.match(w["traffic"]) or w["chips"] not in (1, 4):
            raise ValueError(f"bad workload {w['name']!r}")
    e2e = {e["name"] for e in m["end_to_end"]}
    for e in m["end_to_end"] + m["per_layer"]:
        if not UNIT.match(e["unit"]) or e["better"] not in ("lower", "higher"):
            raise ValueError(f"bad unit or direction on {e['name']!r}")
        if not set(e.get("workloads", [])) <= cells:
            raise ValueError(f"{e['name']!r} lists an unknown cell")
    for e in m["end_to_end"]:
        if e["source"] not in ("host_clock", "device_trace"):
            raise ValueError(f"end-to-end {e['name']!r} takes host_clock or device_trace")
    for e in m["per_layer"]:
        if e["moves"] not in e2e or e["source"] not in (
                "device_trace", "program_span", "program_counter", "host_clock"):
            raise ValueError(f"bad per-layer metric {e['name']!r}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                      # the configuration file
    traffic: dict                     # the traffic file
    limits: dict                      # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(entry: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_of_cell


def load_cell(name: str, root: Path = ROOT, manifest: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `manifest`, in its form)."""
    if manifest is None:
        manifest = json.loads((root / "BENCHMARK.json").read_text())
    check_manifest(manifest)
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"unknown workload {name!r}")
    e2e = [e for e in manifest["end_to_end"] if "workloads" not in e or name in e["workloads"]]
    e2e_names = {e["name"] for e in e2e}
    per_layer = [e for e in manifest["per_layer"] if _reports(e, name, e2e_names)]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return Cell(name, cell["chips"], json.loads((root / conf["file"]).read_text()),
                json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
                json.loads((BENCH / "limits" / f"{name}.json").read_text()), e2e, per_layer)


def load_module(kind: str, name: str):
    """bench_h100/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod            # so that spawned processes find its functions
    spec.loader.exec_module(mod)
    return mod


# -- environment -----------------------------------------------------------------


def pin_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its own kernels into htd_tpu_torch/_build/), and one host
    thread for the CPU's math libraries, so that a run's host work is one
    thread of dispatch; before torch is imported."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


@contextlib.contextmanager
def steady_window():
    """The measured window with Python's collector frozen over what set-up
    made and switched off, so that no collection pauses a request or a
    step; undone after."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def forbidden_modules(names=None) -> List[str]:
    """The top-level names among `names` (the loaded modules by default)
    that are one of FORBIDDEN, compared as whole names."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card(chips: int) -> Dict[str, Any]:
    """The card as the result line names it; exits where there is none or
    too few."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        raise SystemExit(3)
    info: Dict[str, Any] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[1].strip() if out else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "unknown"
    return info


# -- the program's configuration ---------------------------------------------------


def _from_dict(cls, d: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        v = d[f.name]
        if dataclasses.is_dataclass(default):
            kw[f.name] = _from_dict(type(default), v)
        elif isinstance(default, tuple) and default and dataclasses.is_dataclass(default[0]):
            kw[f.name] = tuple(_from_dict(type(default[0]), x) for x in v)
        elif isinstance(v, list):
            kw[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kw[f.name] = v
    return cls(**kw)


def port_config(doc: dict):
    """The program's HTDConfig for a configuration file, checked against
    the preset it names when it names one."""
    from htd_tpu_torch import config as C

    cfg = _from_dict(C.HTDConfig, doc["config"])
    if "preset" in doc:
        want = getattr(C, doc["preset"])(**doc.get("overrides", {}))
        if cfg != want:
            raise ValueError(f"{doc['name']}: the file's config differs from "
                             f"{doc['preset']}({doc.get('overrides', {})})")
    return cfg


# -- one run's outcome -----------------------------------------------------------------


@dataclass
class Outcome:
    """What a generator hands back: end-to-end values, counts, the traced
    stretch and what its readers need, and the numbers that decide
    `correct`."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]
    trace: Optional[Any] = None                  # trace.Trace of rank 0
    info: Dict[str, Any] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float                                    # perf_counter at process start
    device: str = "cuda"
    program: Optional[Callable] = None           # tests swap the system under test here
    keep_pairs: bool = False                     # control.py keeps what was compared
