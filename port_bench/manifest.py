"""`BENCHMARK.json` and the files it names, found by name: a cell, its
configuration, and the metrics a run of the cell reports."""

from __future__ import annotations

import json
import os
import re
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    for w in load()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"port_bench: no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    for c in load()["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as fh:
                return json.load(fh)
    raise SystemExit(f"port_bench: no configuration named {name!r} in BENCHMARK.json")


def metrics_for(cell_name: str, kind: str) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics that a run of the cell reports."""
    return [m for m in load()[kind] if cell_name in m.get("workloads", [cell_name])]
