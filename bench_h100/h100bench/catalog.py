"""Where the benchmark finds each piece, by the names in ``BENCHMARK.json``.

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``;
- a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the value or
  None where the run holds nothing to read;
- a kernel family: every pattern file ``kernels/<family>/*.txt`` (one
  regular expression a line, ``#`` starts a comment), matched against the
  device trace's kernel names;
- a cell's limits for the comparison that decides ``correct``:
  ``limits/<workload>.json``.

Adding a file adds the piece; no code names a cell, a mix or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell:
    """One workload of ``spec`` with its configuration, traffic mix,
    metrics and limits, read from the files under ``bench_dir``."""

    def __init__(self, spec: dict, workload: str, root: str = ROOT,
                 bench_dir: str = BENCH_DIR):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.workload = by_name[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        cfg_entry = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        self.config_name = cfg_entry["name"]
        with open(os.path.join(root, cfg_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic_name = self.workload["traffic"]
        self.traffic = _json(bench_dir, "traffic", self.traffic_name)
        self.limits = _json(bench_dir, "limits", workload)
        self.bench_dir = bench_dir
        self.end_to_end = [m for m in spec["end_to_end"] if _in(m, workload)]
        self.per_layer = [m for m in spec["per_layer"] if _in(m, workload)]

    def reader(self, metric: dict):
        return load_reader(self.bench_dir, metric["name"])


def _in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _json(bench_dir: str, kind: str, name: str) -> dict:
    with open(os.path.join(bench_dir, kind, name + ".json")) as f:
        return json.load(f)


def load_reader(bench_dir: str, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_families(bench_dir: str = BENCH_DIR) -> dict:
    """``{family: [compiled patterns]}`` from ``kernels/<family>/*.txt``."""
    out = {}
    base = os.path.join(bench_dir, "kernels")
    for family in sorted(os.listdir(base)):
        fdir = os.path.join(base, family)
        if not os.path.isdir(fdir):
            continue
        pats = []
        for fn in sorted(os.listdir(fdir)):
            if not fn.endswith(".txt"):
                continue
            with open(os.path.join(fdir, fn)) as f:
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        pats.append(re.compile(line))
        out[family] = pats
    return out


def family_of(name: str, families: dict):
    for family, pats in families.items():
        if any(p.search(name) for p in pats):
            return family
    return None
