"""``tools/experiments/tier1_times_torch.py`` on a small hand-written junit
XML: per-file summed times and pass / skip / fail counts, costliest file
first, then the costliest tests; and it imports neither JAX nor the port."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "experiments", "tier1_times_torch.py")

XML = """<?xml version="1.0" encoding="utf-8"?>
<testsuites><testsuite name="pytest" errors="1" failures="1" skipped="1" tests="6" time="9.0">
<testcase classname="tests.test_a" name="test_one" time="2.5" />
<testcase classname="tests.test_a" name="test_two[x]" time="0.5"><skipped message="no card" /></testcase>
<testcase classname="tests.test_b.TestGroup" name="test_three" time="4.0" />
<testcase classname="tests.test_b.TestGroup" name="test_four" time="1.0"><failure message="bad" /></testcase>
<testcase classname="tests.test_c" name="test_five" time="0.25"><error message="setup" /></testcase>
<testcase classname="tests.test_c" name="test_six" time="0.75" />
</testsuite></testsuites>
"""


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("tier1_times_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_per_file_sums_and_counts(tool, tmp_path, capsys):
    path = tmp_path / "run.xml"
    path.write_text(XML)
    files = tool.per_file(tool.read_cases(str(path)))
    assert [(r["file"], r["seconds"], r["passed"], r["skipped"], r["failed"])
            for r in files] == [("tests/test_b.py", 5.0, 1, 0, 1),
                                ("tests/test_a.py", 3.0, 1, 1, 0),
                                ("tests/test_c.py", 1.0, 1, 0, 1)]
    assert tool.main([str(path), "--top", "2", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["passed"], out["skipped"], out["failed"], out["seconds"]) == (3, 1, 2, 9.0)
    assert [(c["file"], c["name"]) for c in out["top"]] == [
        ("tests/test_b.py", "test_three"), ("tests/test_a.py", "test_one")]
    assert tool.main([str(path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split() == ["tests/test_b.py", "5.00", "1", "0", "1"]
    assert lines[4].split() == ["all", "9.00", "3", "1", "2"]
    assert lines[-1].split() == ["0.25", "failed", "tests/test_c.py::test_five"]


def test_imports_neither_jax_nor_the_port(tmp_path):
    path = tmp_path / "run.xml"
    path.write_text(XML)
    code = ("import runpy, sys\n"
            "sys.argv = [%r, sys.argv[1]]\n"
            "try:\n    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ponderv2_tpu', 'ponderv2_tpu_torch', 'torch')]\n"
            "assert not bad, bad\n" % TOOL)
    out = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                         text=True, timeout=60, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert "tests/test_b.py" in out.stdout.splitlines()[1]
