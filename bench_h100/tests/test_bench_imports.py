"""Nothing a run imports is JAX or the JAX package (top-level names compared
whole: ``opadpo_torch`` is the port, ``opadpo_tpu`` the JAX package), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys

from bench_h100.tests.common import ROOT

HARNESS = ROOT / "bench_h100"
RUN = """
import sys
from bench_h100.run import FORBIDDEN, run_cell, reader, forbidden_modules
from bench_h100.tests.common import bench, tiny_spec
from bench_h100 import calibrate
for m in bench()["per_layer"]:
    reader(m["name"])
run_cell(tiny_spec(), 3, 0.0, False, device="cpu")
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & set(FORBIDDEN)), forbidden_modules())
"""
REFERENCE = """
import sys
from bench_h100.reference import dpo, llava, quant
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("opadpo_torch", "opadpo_tpu", "jax", "jaxlib", "flax")))
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    assert _run(RUN) == "[] []"


def test_the_reference_loads_nothing_of_the_program():
    assert _run(REFERENCE) == "[]"


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_harness_names_jax():
    for path in HARNESS.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "opadpo_tpu"}, \
            path


def test_no_source_of_the_reference_names_the_program():
    for path in (HARNESS / "reference").rglob("*.py"):
        assert "opadpo_torch" not in _imports(path), path


def test_the_forbidden_check_compares_whole_top_level_names():
    from bench_h100.run import FORBIDDEN
    assert "opadpo_tpu" in FORBIDDEN
    assert "opadpo_torch".split(".")[0] not in FORBIDDEN
