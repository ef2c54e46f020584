"""BENCHMARK.json and the files it names: keys, names, units, limits."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves",
               "workloads", "bound"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32
    assert all(one_line(w) for w in MAN["command"])
    files = [w for w in MAN["command"] if "/" in w]
    assert files and all(any(w.startswith(p + "/") for p in MAN["paths"])
                         for w in files)


def test_run_seconds_fits_the_check():
    r = MAN["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    runs = 2 + 14 * 24
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_allowed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def check_config_file(reduced, data):
    """A configuration's file against its entry's `reduced`: the same list
    in both; its program and reference Python files under benchmark/; each
    stack's type, and its weights either a model file held to a sha256 or
    a seed. A configuration of trained model files alone cuts nothing."""
    assert data["reduced"] == reduced and len(reduced) <= 16
    assert all(NAME.match(k) for k in reduced)
    for key in ("program", "reference"):
        path = data[key]
        assert PATH.match(path) and ".." not in path
        assert path.startswith("benchmark/") and path.endswith(".py")
        assert (ROOT / path).is_file()
    seeded = False
    for stack in data["stacks"]:
        assert stack["dtype"] in ("bfloat16", "float32")
        if "seed" in stack:
            assert not {"model", "sha256"} & set(stack)
            assert isinstance(stack["seed"], int)
            assert 0 <= stack["seed"] < 2 ** 63
            seeded = True
        else:
            assert re.fullmatch(r"[0-9a-f]{64}", stack["sha256"])
            assert (ROOT / stack["model"]).is_file()
    if not seeded:
        assert reduced == []


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["source"].startswith("https://")
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = json.loads((ROOT / cfg["file"]).read_text())
    check_config_file(cfg["reduced"], data)
    # the isolation test loads every module there
    assert data["reference"].startswith("benchmark/reference/")
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


def test_a_config_of_seeded_stacks():
    """The toy configuration (benchmark/tests/toy.json): a seed in place of
    a model file, and a `reduced` list; refused where they disagree."""
    toy = json.loads((ROOT / "benchmark" / "tests" / "toy.json").read_text())
    check_config_file(["layers"], toy)
    with pytest.raises(AssertionError):
        check_config_file([], toy)
    both = dict(toy, stacks=[dict(toy["stacks"][0], sha256="0" * 64)])
    with pytest.raises(AssertionError):
        check_config_file(["layers"], both)
    for key in ("program", "reference"):
        with pytest.raises(AssertionError):
            check_config_file(["layers"], dict(toy, **{key: "run.py"}))


@pytest.mark.parametrize("wl", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_entry(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] in (1, 4) and one_line(wl["why"])
    assert NAME.match(wl["traffic"]) and NAME.match(wl["config"])
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    data = json.loads((ROOT / "benchmark" / "workloads" /
                       f"{wl['name']}.json").read_text())
    assert data["config"] == wl["config"] and data["chips"] == wl["chips"]
    assert data["why"] == wl["why"]
    assert all(k.startswith("W2X_") for k in data["env"])
    for g in data["groups"]:
        assert g["frames"] % g["per_dispatch"] == 0
        assert 1 <= g["check_per_group"] <= g["frames"] // g["per_dispatch"]
    assert data["limits"].get("row_psnr_min_db", 0) > 0
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_share():
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert set(m) <= METRIC_KEYS
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_end_to_end():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and one_line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [m for m in MAN["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in MAN["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in e2e} and per


def test_files_are_named_from_names():
    for f in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
