"""BENCHMARK.json: its characters, its keys and the files it names."""

import importlib
import json
import os

from port_bench import manifest, traffic

M = manifest.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_keys():
    assert set(M) == TOP
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]:
        assert manifest.NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in M["configs"] + M["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in M["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert len(json.dumps(M)) < 64 * 1024


def test_files_and_readers():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for c in M["configs"]:
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert manifest.config(c["name"])["guarantees"]["num_queries"] >= 1
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        traffic.load(w["traffic"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(importlib.import_module(f"port_bench.metrics.{m['name']}").read)
    for m in M["per_layer"]:
        assert m["moves"] in e2e
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
