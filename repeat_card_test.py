"""Run one pytest test of a checkout many times in one process and count
how often it fails: a rare failure on the same inputs is a race, or a
reading at the edge of its tolerance.

    python3 repeat_card_test.py [--root DIR] [-n N] NODE_ID

``NODE_ID`` is relative to ``DIR`` (default: this file's directory), e.g.
``tests/test_torch_cuda.py::test_autograd_runs_both_kernels_and_hands_over_the_mask``.
Pytest runs with ``--noconftest`` (the repo's conftest imports JAX), as the
card tests are run on a machine with a GPU.  Prints one JSON line: runs,
passed, failed, skipped, the ``E`` lines of the first failures, seconds.
Exits 1 when the test never ran (it skipped or was not found).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


class _Record:
    """A pytest plugin that keeps each run's outcome."""

    def __init__(self):
        self.outcomes, self.failures = [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.outcomes.append(report.outcome)
            if report.outcome == "failed":
                self.failures.append([line for line in
                                      report.longreprtext.splitlines()
                                      if line.startswith("E ")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("node_id")
    ap.add_argument("--root",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("-n", type=int, default=200)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    import pytest

    record = _Record()
    start = time.perf_counter()
    for _ in range(args.n):
        pytest.main([args.node_id, "-q", "--noconftest", "-p",
                     "no:cacheprovider", "-W", "ignore"], plugins=[record])
    seconds = time.perf_counter() - start
    counts = {k: record.outcomes.count(k)
              for k in ("passed", "failed", "skipped")}
    print(json.dumps({"node_id": args.node_id, "root": root,
                      "runs": args.n, **counts,
                      "first_failures": record.failures[:5],
                      "seconds": seconds}))
    return 0 if counts["passed"] + counts["failed"] else 1


if __name__ == "__main__":
    sys.exit(main())
