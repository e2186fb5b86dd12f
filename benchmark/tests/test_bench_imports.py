"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the system."""

import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

BLOCKER = """
import importlib.abc, sys
BLOCKED = set({blocked!r})
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""

HARNESS = """
import importlib, importlib.util, pathlib
for m in ("benchmark.run", "benchmark.control", "benchmark.faults", "benchmark.trace",
          "benchmark.counts", "benchmark.generate", "benchmark.weights",
          "benchmark.drivers.rollout", "benchmark.reference.check"):
    importlib.import_module(m)
for p in sorted(pathlib.Path("benchmark/metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from benchmark.drivers import rollout
rollout._program()     # the system under test itself
from benchmark import run
assert run.forbidden_modules() == [], run.forbidden_modules()
print("ok")
"""

REFERENCE = """
import benchmark.reference.policy, benchmark.reference.robot, benchmark.reference.check
import benchmark.generate, benchmark.weights, benchmark.counts
import sys
assert not any(m.split(".")[0] == "mpinets_torch" for m in sys.modules)
print("ok")
"""


def run_blocked(blocked, body):
    code = BLOCKER.format(blocked=list(blocked)) + body
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


@pytest.mark.parametrize("body", [HARNESS], ids=["harness_and_system"])
def test_harness_loads_no_jax(body):
    run_blocked(("jax", "jaxlib", "flax", "mpinets_tpu"), body)


def test_reference_imports_nothing_of_the_system():
    run_blocked(("jax", "jaxlib", "flax", "mpinets_tpu", "mpinets_torch"), REFERENCE)


def test_forbidden_names_are_compared_whole():
    from benchmark import run

    sys.modules.setdefault("jaxtyping_like_name", sys)   # a prefix is not a match
    assert "jaxtyping_like_name" not in run.forbidden_modules()
    assert set(run.FORBIDDEN) == {"jax", "jaxlib", "flax", "mpinets_tpu"}
