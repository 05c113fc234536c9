"""The per-test time limit and the slow list of the repo's root conftest.py.

A body past its limit fails with a message that names the limit; a body
within it passes and leaves neither of the limit's two timers armed; a
failed phase does not disarm the backstop. These run in a process of their
own, so that the limit they arm does not replace the one this test runs
under. The slow list names only tests of files that test the reference
alone, and each name is a test there."""

import ast
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# the root conftest.py, by its path: ``conftest`` is also tests/conftest.py
_spec = importlib.util.spec_from_file_location("root_conftest",
                                               ROOT / "conftest.py")
limits = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(limits)

HEADER = f"""
import faulthandler, signal, sys, time
sys.path.insert(0, {str(ROOT)!r})
import pytest
import conftest
from conftest import time_limit
"""

CHILD = HEADER + """
t0 = time.monotonic()
try:
    with time_limit(1, "the sleeper"):
        time.sleep(5)
except pytest.fail.Exception as e:
    print("failed after", time.monotonic() - t0, "s:", e)
else:
    raise SystemExit("the sleeper was not stopped")

with time_limit(5, "the quick one", grace_s=0.5):
    time.sleep(0.1)
assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
time.sleep(6)  # past the backstop's 5.5 s, which would end this process
print("no timer left")
"""

# a test whose call failed and whose teardown is stuck in C code: pytest's
# faulthandler plugin cancels the dump on the failure, the root conftest's
# hook arms it again, and the limit's own signal never reaches Python
STUCK_AFTER_A_FAILURE = HEADER + """
with time_limit(1, "the stuck one", grace_s=1):
    faulthandler.cancel_dump_traceback_later()
    conftest.pytest_exception_interact()
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(20)
print("still alive")
"""


def _child(source):
    return subprocess.run([sys.executable, "-c", source], capture_output=True,
                          text=True, timeout=60)


def test_time_limit_fails_a_body_past_it_and_disarms_after():
    proc = _child(CHILD)
    assert proc.returncode == 0, proc.stderr
    failed, done = proc.stdout.splitlines()[-2:]
    seconds = float(failed.split()[2])
    assert 1 <= seconds < 2, failed
    assert "the sleeper ran past its 1 s time limit" in failed
    assert done == "no timer left"


def test_backstop_ends_a_body_stuck_after_a_failed_phase():
    t0 = time.monotonic()
    proc = _child(STUCK_AFTER_A_FAILURE)
    assert time.monotonic() - t0 < 15
    assert proc.returncode != 0
    assert "still alive" not in proc.stdout
    assert proc.stderr.startswith("Timeout (0:00:0"), proc.stderr


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(limits.SLOW_REFERENCE_TESTS))
def test_slow_list_names_reference_only_tests(path):
    source = ROOT / path
    imports = _imports(source)
    assert "egobox_tpu" in imports and "egobox_torch" not in imports
    tests = {node.name for node in ast.parse(source.read_text()).body
             if isinstance(node, ast.FunctionDef)
             and node.name.startswith("test_")}
    missing = set(limits.SLOW_REFERENCE_TESTS[path]) - tests
    assert not missing


class _Item:
    def __init__(self, nodeid):
        self.nodeid = nodeid
        self.originalname = nodeid.split("::")[1].split("[")[0]
        self.marks = []

    def add_marker(self, mark):
        self.marks.append(mark.name)


def test_slow_list_marks_every_case_of_a_listed_test_and_nothing_else():
    items = [_Item("tests/test_dist_fit.py::"
                   "test_dist_grad_matches_single_device[matern32]"),
             _Item("tests/test_gp.py::test_multidraw_warmstart"),
             _Item("tests/test_torch_gp.py::test_multidraw_warmstart"),
             _Item("tests/test_gp.py::test_multidraw_warmstart_other")]
    limits.pytest_collection_modifyitems(items)
    assert [i.marks for i in items] == [["slow"], ["slow"], [], []]


STUCK_FILE = """
import signal, time

def test_first():
    pass

def test_stuck():
    # as if stuck inside C code: the limit's signal never reaches Python
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(100)

def test_after():
    pass
"""


def test_lane_carries_on_past_a_worker_the_backstop_ended(tmp_path):
    # the root conftest with a 2 s limit and a 2 s grace, in a tree of its
    # own: a stuck test, the test after it in its file, and two more files
    conftest = (ROOT / "conftest.py").read_text()
    for name in ("TEST_TIME_LIMIT_S", "BACKSTOP_GRACE_S"):
        assert f"\n{name} = " in conftest
        conftest = "\n".join(f"{name} = 2" if line.startswith(f"{name} = ")
                             else line for line in conftest.split("\n"))
    (tmp_path / "conftest.py").write_text(conftest)
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "test_a_stuck.py").write_text(STUCK_FILE)
    for name in ("b", "c"):
        (tmp_path / f"test_{name}.py").write_text(
            "def test_one():\n    pass\n\ndef test_two():\n    pass\n")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "2", "--dist", "loadfile", "-p", "no:randomly",
         str(tmp_path)], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    out = proc.stdout
    assert time.monotonic() - t0 < 60, out
    assert proc.returncode == 1, out
    assert "crashed while running 'test_a_stuck.py::test_stuck'" in out, out
    assert "1 failed, 6 passed" in out, out
