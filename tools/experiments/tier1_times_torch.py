"""Per-file times of a pytest run, from its junit XML.

Reads the XML that ``pytest --junitxml=PATH`` writes (under xdist too) and
prints, for each test file, the summed time of its test cases (pytest counts
a test's fixture setup and teardown in its time, so a module fixture's cost
lands on the first test that asks for it) with its pass, skip and fail
counts, costliest file first; then the ``--top`` costliest tests::

    python tools/experiments/tier1_times_torch.py run.xml [--top 15] [--json]

A test case counts as failed when it holds a ``failure`` or an ``error``,
as skipped when it holds a ``skipped``, else as passed. ``--json`` prints
one JSON object instead of the tables. Imports only the standard library.
"""

from __future__ import annotations

import argparse
import json
import sys
import xml.etree.ElementTree as ET
from typing import Dict, List, NamedTuple


class Case(NamedTuple):
    file: str
    name: str
    seconds: float
    status: str  # "passed", "skipped" or "failed"


def file_of(classname: str) -> str:
    """``tests.test_x.TestY`` -> ``tests/test_x.py``: the dotted path up to
    its first module named ``test_*``."""
    parts = classname.split(".")
    for i, part in enumerate(parts):
        if part.startswith("test_"):
            return "/".join(parts[:i + 1]) + ".py"
    return "/".join(parts) + ".py" if classname else "<unknown>"


def read_cases(path: str) -> List[Case]:
    cases = []
    for case in ET.parse(path).getroot().iter("testcase"):
        tags = {child.tag for child in case}
        status = ("failed" if tags & {"failure", "error"} else
                  "skipped" if "skipped" in tags else "passed")
        cases.append(Case(file_of(case.get("classname", "")), case.get("name", ""),
                          float(case.get("time", 0.0) or 0.0), status))
    return cases


def per_file(cases: List[Case]) -> List[Dict]:
    files: Dict[str, Dict] = {}
    for c in cases:
        row = files.setdefault(c.file, dict(file=c.file, seconds=0.0, passed=0,
                                            skipped=0, failed=0))
        row["seconds"] += c.seconds
        row[c.status] += 1
    return sorted(files.values(), key=lambda r: (-r["seconds"], r["file"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml", help="the junit XML of a pytest run")
    ap.add_argument("--top", type=int, default=15, help="how many costliest tests")
    ap.add_argument("--json", action="store_true", help="print one JSON object")
    args = ap.parse_args(argv)
    cases = read_cases(args.xml)
    files = per_file(cases)
    top = sorted(cases, key=lambda c: -c.seconds)[:args.top]
    totals = {s: sum(c.status == s for c in cases) for s in ("passed", "skipped", "failed")}
    summed = sum(c.seconds for c in cases)
    if args.json:
        print(json.dumps(dict(files=files, top=[c._asdict() for c in top],
                              seconds=summed, **totals)))
        return 0
    width = max([len(r["file"]) for r in files] + [4])
    print(f"{'file':<{width}} {'seconds':>9} {'passed':>6} {'skipped':>7} {'failed':>6}")
    for r in files:
        print(f"{r['file']:<{width}} {r['seconds']:9.2f} {r['passed']:6d} "
              f"{r['skipped']:7d} {r['failed']:6d}")
    print(f"{'all':<{width}} {summed:9.2f} {totals['passed']:6d} "
          f"{totals['skipped']:7d} {totals['failed']:6d}")
    print(f"\nthe {len(top)} costliest tests:")
    for c in top:
        print(f"{c.seconds:9.2f}  {c.status:<7}  {c.file}::{c.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
