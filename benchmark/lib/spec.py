"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each metric names its reader. They are found so:

    configuration  the `file` of its entry in `configs` (JSON)
    traffic mix    benchmark/traffic/<traffic>.json, whose "client" names
                   benchmark/clients/<client>.py (lib/traffic.py)
    limits         benchmark/limits/<workload>.json, the limit of each
                   number that the cell's `correct` compares
    metric         benchmark/metrics/<metric>.py, a module with read(ctx)
    reference      benchmark/reference/<config's "reference">.py

so that a cell, a configuration, a mix or a metric is added by adding
files and entries, without editing a file already there.

A configuration's file gives its model in one of two forms (`trees`):

    one tree       "parts" P, "mixtures" K, "parents" (P,), "components" 1:
                   part p's mixture k is filter p*K + k of a pool of P*K
    several trees  "pool" F, "mixtures" K and "trees", one entry a
                   component: {"parents": (P_c,), "filters": P_c rows of
                   K indices into the pool of F filters}; components may
                   differ in size and depth and share filters

Parts are root first (parents[0] == 0, parents[p] < p). Four optional
keys widen either form; absent, each means what the line says:

    filter_sizes   one [fh, fw] per pool filter (absent: every filter is
                   the file's filter_h x filter_w)
    ds             one entry a part, 0 or 1, the root's 0: a part at 1
                   lies one octave finer than its parent (the anchor's
                   ds of detect_fast.m); in a tree of the several-tree
                   form, or beside "parents" in the one-tree form
                   (absent: every part on its parent's level)
    maxsize        [h, w], the pyramid's padding size, as the MATLAB
                   code's model.maxsize (absent: the largest filter
                   height and width, so filter_h x filter_w where every
                   filter has that size)
    pyramid        "pose" or "dpm", the feature pyramid's form (absent:
                   "pose"): "pose" the pose and face releases'
                   featpyramid.m, every level at sbin, an octave a
                   binomial reduce of the one above; "dpm" voc-release4's
                   featpyramid.m, an octave of HOG at sbin / 2 on the
                   first octave's images before those levels, and each
                   later octave an area resize by 0.5. "dpm" needs an
                   even sbin of at least 4 and a part at ds = 1 in every
                   tree, so that no root lies on the half-cell octave
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
PYRAMIDS = {"pose", "dpm"}


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, breaks the benchmark's rules."""


def check_name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise SpecError(f"{what}: {value!r} is not a name of [A-Za-z0-9_.-] "
                        "(at most 64, not starting with . or -)")
    return value


def check_unit(value, what: str) -> str:
    if not isinstance(value, str) or not UNIT.fullmatch(value):
        raise SpecError(f"{what}: unit {value!r} is not 1-16 of [A-Za-z0-9_/%.-]")
    return value


def _line(value, what: str) -> str:
    if not isinstance(value, str) or not 1 <= len(value) <= 200 or "\n" in value \
            or "\t" in value:
        raise SpecError(f"{what}: must be one line of 1-200 characters")
    return value


def _whole(value) -> bool:
    return not isinstance(value, bool) and isinstance(value, int) and value >= 1


def _count(value, what: str) -> int:
    if not _whole(value):
        raise SpecError(f"{what}: {value!r} is not a whole number of at least 1")
    return value


def _tree(parents, filters, ds, pool: int, k: int, what: str) -> dict:
    if not isinstance(parents, list) or not parents:
        raise SpecError(f"{what}: parents must be a list of at least one part")
    for p, q in enumerate(parents):
        if isinstance(q, bool) or not isinstance(q, int) or not (0 <= q < p or p == q == 0):
            raise SpecError(f"{what}: part {p}'s parent {q!r} is not a part before it")
    if not isinstance(filters, list) or len(filters) != len(parents):
        raise SpecError(f"{what}: {len(parents)} parts need as many rows of filters")
    for p, row in enumerate(filters):
        if not isinstance(row, list) or len(row) != k:
            raise SpecError(f"{what}: part {p} names {row!r}, not {k} pool filters")
        for f in row:
            if isinstance(f, bool) or not isinstance(f, int) or not 0 <= f < pool:
                raise SpecError(f"{what}: part {p}'s filter {f!r} is outside the pool of {pool}")
    if ds is None:
        ds = [0] * len(parents)
    if not isinstance(ds, list) or len(ds) != len(parents):
        raise SpecError(f"{what}: ds must list the {len(parents)} parts")
    for p, d in enumerate(ds):
        if isinstance(d, bool) or not isinstance(d, int) or d not in (0, 1):
            raise SpecError(f"{what}: part {p}'s ds {d!r} is not 0 or 1")
    if ds[0]:
        raise SpecError(f"{what}: part 0, the root, has ds {ds[0]!r}; a root lies on its own level")
    return {"parents": list(parents), "filters": [list(r) for r in filters], "ds": list(ds)}


def _sizes(cfg: dict, pool: int, what: str) -> List[Tuple[int, int]]:
    given = cfg.get("filter_sizes")
    if given is None:
        if not (_whole(cfg.get("filter_h")) and _whole(cfg.get("filter_w"))):
            raise SpecError(f"{what}: give filter_h and filter_w, or filter_sizes")
        return [(cfg["filter_h"], cfg["filter_w"])] * pool
    if not isinstance(given, list) or len(given) != pool:
        raise SpecError(f"{what}: filter_sizes must give one [fh, fw] to each of the "
                        f"{pool} pool filters")
    for f, size in enumerate(given):
        if not isinstance(size, list) or len(size) != 2 or not all(_whole(x) for x in size):
            raise SpecError(f"{what}: filter {f}'s size {size!r} is not [fh, fw] of whole "
                            "numbers of at least 1")
    return [tuple(size) for size in given]


def _maxsize(cfg: dict, sizes: List[Tuple[int, int]], what: str) -> Tuple[int, int]:
    given = cfg.get("maxsize")
    if given is None:
        return max(h for h, _ in sizes), max(w for _, w in sizes)
    if not isinstance(given, list) or len(given) != 2 or not all(_whole(x) for x in given):
        raise SpecError(f"{what}: maxsize {given!r} is not [h, w] of whole numbers of at least 1")
    return tuple(given)


def trees(cfg: dict) -> Tuple[int, List[dict]]:
    """(pool size, trees) of a configuration in either form (above), each
    tree {"parents", "filters", "ds"}: the one tree is the one-component
    case. Raises SpecError where the model, its sizes or its padding
    are malformed."""
    what = f"config {cfg.get('name')}"
    k = _count(cfg.get("mixtures"), f"{what}: mixtures")
    if "trees" in cfg:
        for key in ("parts", "parents", "ds"):
            if key in cfg:
                raise SpecError(f"{what}: {key!r} belongs to the one-tree form, not beside trees")
        pool = _count(cfg.get("pool"), f"{what}: pool")
        given = cfg["trees"]
        if not isinstance(given, list) or not given:
            raise SpecError(f"{what}: trees must be a list of at least one component")
        if cfg.get("components", len(given)) != len(given):
            raise SpecError(f"{what}: components {cfg['components']!r} for {len(given)} trees")
        out = []
        for c, t in enumerate(given):
            if not isinstance(t, dict) or not {"parents", "filters"} <= set(t) <= \
                    {"parents", "filters", "ds"}:
                raise SpecError(f"{what}: tree {c} must have the keys parents and filters, "
                                "and may have ds")
            out.append(_tree(t["parents"], t["filters"], t.get("ds"), pool, k,
                             f"{what}: tree {c}"))
    else:
        parts = _count(cfg.get("parts"), f"{what}: parts")
        if cfg.get("components", 1) != 1:
            raise SpecError(f"{what}: the one-tree form has one component; give trees for more")
        parents = cfg.get("parents")
        if not isinstance(parents, list) or len(parents) != parts:
            raise SpecError(f"{what}: parents must list the {parts} parts")
        filters = [[p * k + m for m in range(k)] for p in range(parts)]
        pool = parts * k
        out = [_tree(parents, filters, cfg.get("ds"), pool, k, what)]
    _maxsize(cfg, _sizes(cfg, pool, what), what)
    _pyramid(cfg, out, what)
    return pool, out


def _pyramid(cfg: dict, trees: List[dict], what: str) -> str:
    form = cfg.get("pyramid", "pose")
    if not isinstance(form, str) or form not in PYRAMIDS:
        raise SpecError(f"{what}: pyramid {form!r} is not one of {sorted(PYRAMIDS)}")
    if form == "dpm":
        sbin = cfg.get("sbin")
        if not _whole(sbin) or sbin % 2 or sbin < 4:
            raise SpecError(f"{what}: pyramid 'dpm' needs an even sbin of at least 4 (its "
                            f"half-cell octave takes cells of sbin / 2), not {sbin!r}")
        for c, t in enumerate(trees):
            if 1 not in t["ds"]:
                raise SpecError(f"{what}: pyramid 'dpm': tree {c} has no part at ds = 1, so "
                                "its roots would lie on the half-cell octave")
    return form


def filter_sizes(cfg: dict) -> List[Tuple[int, int]]:
    """(fh, fw) of each pool filter, in pool order."""
    return _sizes(cfg, trees(cfg)[0], f"config {cfg.get('name')}")


def maxsize(cfg: dict) -> Tuple[int, int]:
    """(h, w) that the pyramid pads by (featpyramid.m: maxsize - 2)."""
    return _maxsize(cfg, filter_sizes(cfg), f"config {cfg.get('name')}")


def pyramid(cfg: dict) -> str:
    """The feature pyramid's form, "pose" or "dpm" (above)."""
    return _pyramid(cfg, trees(cfg)[1], f"config {cfg.get('name')}")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" or "per_layer"
    workloads: Optional[tuple]
    bound: Optional[float] = None
    layer: Optional[str] = None
    moves: Optional[str] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads

    def reader_path(self, bench_dir: Path = BENCH_DIR) -> Path:
        return bench_dir / "metrics" / f"{self.name}.py"


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    config: str
    traffic: str
    chips: int


@dataclasses.dataclass
class Spec:
    data: dict
    bench_dir: Path
    configs: Dict[str, dict]
    workloads: Dict[str, Workload]
    metrics: List[Metric]

    @property
    def run_seconds(self) -> int:
        return int(self.data["run_seconds"])

    def workload(self, name: str) -> Workload:
        if name not in self.workloads:
            raise SpecError(f"no workload {name!r}; have {sorted(self.workloads)}")
        return self.workloads[name]

    def metrics_for(self, cell: str, kind: str) -> List[Metric]:
        return [m for m in self.metrics if m.kind == kind and m.applies(cell)]

    def config(self, name: str) -> dict:
        """The configuration's file, as JSON."""
        path = self.bench_dir.parent / self.configs[name]["file"]
        return json.loads(path.read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads(self.limits_path(workload).read_text())

    def limits_path(self, workload: str) -> Path:
        return self.bench_dir / "limits" / f"{workload}.json"

    def reference_path(self, config: dict) -> Path:
        return self.bench_dir / "reference" / f"{check_name(config['reference'], 'reference')}.py"


def load_module(path: Path, name: str):
    """A module loaded from a file by its path (metric readers and
    references have names with dots), once a process."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise SpecError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def load(bench_json: Path = ROOT / "BENCHMARK.json",
         bench_dir: Optional[Path] = None) -> Spec:
    """Read and check BENCHMARK.json and every file it names."""
    bench_dir = bench_dir or bench_json.parent / "benchmark"
    data = json.loads(bench_json.read_text())
    if set(data) != TOP_KEYS:
        raise SpecError(f"keys {sorted(data)} are not {sorted(TOP_KEYS)}")
    configs = {}
    for c in data["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise SpecError(f"config {c.get('name')}: keys {sorted(c)}")
        check_name(c["name"], "config")
        for key in c["reduced"]:
            check_name(key, f"config {c['name']}: reduced")
        _line(c["source"], f"config {c['name']}: source")
        _line(c["why"], f"config {c['name']}: why")
        path = bench_json.parent / c["file"]
        if not path.is_file():
            raise SpecError(f"config {c['name']}: {c['file']} not found")
        trees(json.loads(path.read_text()))
        configs[c["name"]] = c
    workloads = {}
    for w in data["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise SpecError(f"workload {w.get('name')}: keys {sorted(w)}")
        cell = Workload(check_name(w["name"], "workload"), check_name(w["config"], "config"),
                        check_name(w["traffic"], "traffic"), int(w["chips"]))
        _line(w["why"], f"workload {cell.name}: why")
        if cell.config not in configs:
            raise SpecError(f"workload {cell.name}: no config {cell.config}")
        if cell.chips not in (1, 4):
            raise SpecError(f"workload {cell.name}: chips {cell.chips}")
        workloads[cell.name] = cell
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in data[kind]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            if not keys <= set(m) <= keys | {"workloads"}:
                raise SpecError(f"metric {m.get('name')}: keys {sorted(m)}")
            if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
                raise SpecError(f"metric {m['name']}: better/source")
            cells = m.get("workloads")
            for cell in cells or ():
                if cell not in workloads:
                    raise SpecError(f"metric {m['name']}: no workload {cell}")
            metric = Metric(check_name(m["name"], "metric"), check_unit(m["unit"], m["name"]),
                            m["better"], m["source"], kind,
                            tuple(cells) if cells is not None else None,
                            m.get("bound"), m.get("layer"), m.get("moves"))
            if kind == "per_layer":
                _line(metric.layer, f"metric {metric.name}: layer")
            if not metric.reader_path(bench_dir).is_file():
                raise SpecError(f"metric {metric.name}: no reader "
                                f"{metric.reader_path(bench_dir).relative_to(bench_dir.parent)}")
            metrics.append(metric)
    names = [m.name for m in metrics]
    if len(set(names)) != len(names):
        raise SpecError("two metrics share a name")
    spec = Spec(data, bench_dir, configs, workloads, metrics)
    from . import traffic

    for cell in workloads.values():
        if not traffic.path(bench_dir, cell.traffic).is_file():
            raise SpecError(f"workload {cell.name}: no traffic file "
                            f"benchmark/traffic/{cell.traffic}.json")
        traffic.load(bench_dir, cell.traffic)
        if not spec.limits_path(cell.name).is_file():
            raise SpecError(f"workload {cell.name}: no limits file "
                            f"benchmark/limits/{cell.name}.json")
        if not spec.reference_path(spec.config(cell.config)).is_file():
            raise SpecError(f"workload {cell.name}: no reference for {cell.config}")
    return spec
