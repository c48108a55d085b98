"""BENCHMARK.json and the files it names, found by name, and the rules the
file has to keep (`python -m benchmark.run --check`).

Layout under benchmark/ (a later change adds a cell by adding files and
entries, and edits none that is there):

  configs/<config>.json   the configuration as it is run ("program": the
                          port's Config fields) and its plain reference
                          ("reference": a module of benchmark/reference/)
  traffic/<traffic>.json  the traffic mix: the output cadence and whether
                          the runs go through the port's mesh path
  cells/<cell>.json       the limits of the numbers that decide `correct`,
                          with the readings each was set from
  metrics/<metric>.py     one reader per metric: read(reading) -> number
                          or None (nothing to read)
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
LAYER_SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAX_BYTES = 64 * 1024
MAX_RUN_SECONDS = 51


def load(path: Path = BENCHMARK_JSON) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration file of config `name`, parsed."""
    with open(ROOT / _by_name(bench["configs"], name, "config")["file"]) as fh:
        return json.load(fh)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    with open(HERE / "cells" / f"{name}.json") as fh:
        return json.load(fh)


def metric_reader(name: str):
    """metrics/<name>.py's read function (a name may hold dots, so the file
    is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end metrics with --trace 0,
    its per-layer metrics with --trace 1 (an entry without `workloads`
    counts for every cell)."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def _line(text, limit: int = 200) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text \
        and "\t" not in text


def _metric_problems(m: dict, keys: set, sources: set, what: str) -> list[str]:
    out = []
    if not (keys <= set(m) <= keys | {"workloads"}):
        out.append(f"{what} {m.get('name')!r}: keys {sorted(m)} (want {sorted(keys)}"
                   " and optionally workloads)")
        return out
    if not NAME.match(str(m["name"])):
        out.append(f"{what} name {m['name']!r}")
    if not UNIT.match(str(m["unit"])):
        out.append(f"{what} {m['name']}: unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        out.append(f"{what} {m['name']}: better {m['better']!r}")
    if m["source"] not in sources:
        out.append(f"{what} {m['name']}: source {m['source']!r}")
    if "roofline" in m["name"] or "mfu" in m["name"]:
        if m["unit"] != "%":
            out.append(f"{what} {m['name']}: a share of a roofline or peak is in %")
    return out


def problems(bench: dict, raw_bytes: int | None = None) -> list[str]:
    """Every way `bench` breaks the rules of BENCHMARK.json; [] when none."""
    out = []
    if raw_bytes is not None and raw_bytes > MAX_BYTES:
        out.append(f"BENCHMARK.json is {raw_bytes} bytes, over {MAX_BYTES}")
    if set(bench) != TOP_KEYS:
        return out + [f"top-level keys {sorted(bench)} != {sorted(TOP_KEYS)}"]
    paths = bench["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        out.append("paths: 1 to 16 directories")
    for p in paths:
        if not (isinstance(p, str) and PATH.match(p)) or p.startswith("/") \
                or ".." in p.split("/"):
            out.append(f"paths: {p!r}")
    cmd = bench["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command: 1 to 32 words of 1 to 200 characters")
    else:
        for w in cmd:
            if w.startswith("/") or ".." in w.split("/"):
                out.append(f"command word {w!r} leads outside the checkout")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and not isinstance(rs, bool) and 1 <= rs <= MAX_RUN_SECONDS):
        out.append(f"run_seconds {rs!r}: a whole number from 1 to {MAX_RUN_SECONDS}")

    configs, workloads = bench["configs"], bench["workloads"]
    if not 1 <= len(configs) <= 24:
        out.append("configs: 1 to 24")
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            out.append(f"config {c.get('name')!r}: keys {sorted(c)}")
            continue
        if not NAME.match(str(c["name"])):
            out.append(f"config name {c['name']!r}")
        if not (_line(c["source"]) and _line(c["why"])):
            out.append(f"config {c['name']}: source and why on one line of 1 to 200")
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
                and all(NAME.match(str(k)) for k in c["reduced"])):
            out.append(f"config {c['name']}: reduced")
        f = c["file"]
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {c['name']}: file {f!r} is under no path")
        elif not (ROOT / f).is_file():
            out.append(f"config {c['name']}: no file {f}")
        if f in files:
            out.append(f"config {c['name']}: file {f} is another config's")
        files.add(f)
    config_names = [c.get("name") for c in configs]
    if len(set(config_names)) != len(config_names):
        out.append("two configs share a name")

    if not 1 <= len(workloads) <= 24:
        out.append("workloads: 1 to 24")
    pairs = set()
    for w in workloads:
        if set(w) != WORKLOAD_KEYS:
            out.append(f"workload {w.get('name')!r}: keys {sorted(w)}")
            continue
        if not (NAME.match(str(w["name"])) and NAME.match(str(w["traffic"]))):
            out.append(f"workload {w['name']!r}: name or traffic")
        if w["config"] not in config_names:
            out.append(f"workload {w['name']}: no config {w['config']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']!r}")
        if not _line(w["why"]):
            out.append(f"workload {w['name']}: why on one line of 1 to 200")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: config and traffic pair repeats")
        pairs.add((w["config"], w["traffic"]))
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic/{w['traffic']}.json")
        if not (HERE / "cells" / f"{w['name']}.json").is_file():
            out.append(f"workload {w['name']}: no cells/{w['name']}.json")
    names = [w.get("name") for w in workloads]
    if len(set(names)) != len(names):
        out.append("two workloads share a name")
    for name in config_names:
        if not any(w.get("config") == name for w in workloads):
            out.append(f"config {name} is used by no workload")
    four = sum(w.get("chips") == 4 for w in workloads)
    if four > max(1, len(workloads) // 4):
        out.append(f"{four} cells ask for 4 chips; at most max(1, 25% rounded down)")

    e2e, layers = bench["end_to_end"], bench["per_layer"]
    if not 1 <= len(e2e) <= 16:
        out.append("end_to_end: 1 to 16")
    if not 1 <= len(layers) <= 128:
        out.append("per_layer: 1 to 128")
    for m in e2e:
        out += _metric_problems(m, E2E_KEYS, E2E_SOURCES, "end_to_end")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0 < b <= 0.25):
            out.append(f"end_to_end {m.get('name')}: bound {b!r} not in (0, 0.25]")
    e2e_names = {m.get("name") for m in e2e}
    if "setup_s" not in e2e_names:
        out.append("end_to_end has no setup_s")
    metric_names = [m.get("name") for m in e2e + layers]
    if len(set(metric_names)) != len(metric_names):
        out.append("two metrics share a name")
    for m in layers:
        out += _metric_problems(m, LAYER_KEYS, LAYER_SOURCES, "per_layer")
        if not _line(m.get("layer")):
            out.append(f"per_layer {m.get('name')}: layer on one line of 1 to 200")
        if m.get("moves") not in e2e_names:
            out.append(f"per_layer {m.get('name')}: moves {m.get('moves')!r}, no "
                       "end-to-end metric")
    for m in e2e + layers:
        for cell_name in m.get("workloads", []):
            if cell_name not in names:
                out.append(f"metric {m.get('name')}: no workload {cell_name!r}")
        if not (HERE / "metrics" / f"{m.get('name')}.py").is_file():
            out.append(f"metric {m.get('name')}: no metrics/{m.get('name')}.py")
    by_e2e = {m.get("name"): m for m in e2e}
    for m in layers:
        moved = by_e2e.get(m.get("moves"))
        if moved is None:
            continue
        reporting = set(moved.get("workloads", names))
        for cell_name in m.get("workloads", names):
            if cell_name not in reporting:
                out.append(f"per_layer {m['name']} is read in {cell_name}, which does "
                           f"not report {m['moves']}")
    for cell_name in names:
        cell_e2e = {m["name"] for m in e2e if cell_name in m.get("workloads", [cell_name])}
        if "setup_s" not in cell_e2e or len(cell_e2e) < 2:
            out.append(f"workload {cell_name}: needs setup_s and another end-to-end metric")
        if not any(cell_name in m.get("workloads", [cell_name]) for m in layers):
            out.append(f"workload {cell_name}: needs a per-layer metric")
    return out
