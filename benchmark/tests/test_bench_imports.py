"""What the benchmark imports: nothing of JAX or the JAX package anywhere,
and nothing of the program in the reference, in what it is built from, or
in a reference file that a configuration names. Module names are compared
by their top-level name, whole: the port's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "cfear_radarodometry_code_public_tpu"}
PORT = "cfear_radarodometry_code_public_tpu_torch"
# the reference and what it is built from: plain numpy and torch only
PLAIN = ("reference.py", "work.py", "roofline.py", "synthetic.py",
         "traffic_gen.py")


def _named_references(bench=BENCH):
    """The reference files that configurations under `bench`/configs/ name
    (their key "reference")."""
    names = set()
    for path in glob.glob(os.path.join(bench, "configs", "*.json")):
        with open(path) as f:
            name = json.load(f).get("reference")
        if name is not None:
            names.add(name)
    return sorted(names)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return sorted(glob.glob(os.path.join(BENCH, "*.py"))
                  + glob.glob(os.path.join(BENCH, "metrics", "*.py")))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _top_level_imports(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for name in PLAIN + tuple(_named_references()):
        got = _top_level_imports(os.path.join(BENCH, name))
        assert PORT not in got, name
        assert got <= {"__future__", "concurrent", "math", "os", "types",
                       "typing", "numpy", "torch", "benchmark"}, (name, got)


def test_the_named_references_are_found(reference_root):
    root = reference_root("reference_copy.py", "import torch\n")
    assert _named_references(os.path.join(root, "benchmark")) \
        == ["reference_copy.py"]


def test_whole_names_are_compared():
    assert PORT.split(".")[0] not in JAX
    assert PORT.startswith("cfear_radarodometry_code_public_tpu")


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_module():
    named = "".join(
        f"\nspec = importlib.util.spec_from_file_location('r{i}', {path!r})"
        "\nspec.loader.exec_module(importlib.util.module_from_spec(spec))"
        for i, path in enumerate(os.path.join(BENCH, n)
                                 for n in _named_references()))
    mods = _modules_after("import importlib.util, benchmark.reference, "
                          "benchmark.work, benchmark.traffic_gen, "
                          "benchmark.roofline" + named)
    assert PORT not in mods and not mods & JAX


def test_a_run_loads_no_jax(tiny_root):
    mods = _modules_after(
        "import torch\ntorch.set_num_threads(2)\nfrom benchmark import "
        f"harness\nharness.run_cell('tiny4', 5, 1.0, True, 'cpu', root="
        f"{tiny_root!r}, log=lambda m: None)\n"
        "assert not harness.forbidden_modules()")
    assert PORT in mods and not mods & JAX
