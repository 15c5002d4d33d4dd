"""BENCHMARK.json against the benchmark's contract: its keys, the charset
of every name and unit, the limits on bounds and sizes, and the files each
entry names."""
import json
import re

import pytest

from conftest import BENCH

ROOT = BENCH.parent
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert list(DATA) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert len(DATA["command"]) <= 32 and all(_line(w) for w in DATA["command"])
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for w in DATA["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in DATA["paths"])


def test_names_and_units_use_the_allowed_characters():
    names = []
    for c in DATA["configs"]:
        names.append(c["name"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in DATA["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        got = [e["name"] for e in DATA[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entries_have_just_the_contract_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in DATA["paths"])
        assert (ROOT / c["file"]).is_file()
    assert len({c["file"] for c in DATA["configs"]}) == len(DATA["configs"])
    assert len({c["source"] for c in DATA["configs"]}) == len(DATA["configs"])
    configs = {c["name"] for c in DATA["configs"]}
    assert configs == {w["config"] for w in DATA["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in DATA["workloads"]) <= max(
        1, len(DATA["workloads"]) // 4)
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in DATA["end_to_end"]}
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    names = {w["name"] for w in DATA["workloads"]}
    for cell in names:
        e2e = [m["name"] for m in DATA["end_to_end"]
               if cell in m.get("workloads", [cell])]
        layer = [m for m in DATA["per_layer"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:  # the metric it moves is reported in the same cell
            assert m["moves"] in e2e


@pytest.mark.parametrize("w", DATA["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "generators" / f"{mix['generator']}.py").is_file()
    assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_under_paths_use_name_characters():
    for p in DATA["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = str(f.relative_to(ROOT))
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
