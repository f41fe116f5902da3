"""``BENCHMARK.json`` finds every file it names, and keeps to the form the
benchmark's contract sets."""

import json
import os
import re

import pytest

from benchmark.harness import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(entry):
    from ponderv2_tpu_torch.utils.config import Config

    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    path = os.path.join(core.ROOT, entry["file"])
    assert entry["file"].startswith("benchmark/configs/")
    cfg = Config.fromfile(path)
    assert cfg.source == entry["source"]
    # every key the file says a run changes is listed, and no width
    assert set(cfg.reduced) <= set(entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "channels")) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_resolve(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    mix = core.mix(cell["traffic"])
    assert core.driver(mix["driver"]).run
    assert core.limits(cell["name"]), "a cell needs the limits of its check"
    e2e = [m["name"] for m in core.cell_metrics(BENCH, cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert core.cell_metrics(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_files_resolve_and_agree(section):
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in BENCH[s]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        reader = core.metric_reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
            assert m["moves"] in e2e
            # each cell it lists reports the metric it moves
            for w in m["workloads"]:
                assert m["moves"] in [x["name"] for x in
                                      core.cell_metrics(BENCH, w, "end_to_end")]
