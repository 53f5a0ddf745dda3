"""What the benchmark may import: nothing of JAX or the JAX package
anywhere (top-level module names compared whole, since the port's name
begins with the JAX package's), and nothing of the program in the
reference; and nothing of it reads the JAX package's benchmark."""

import ast
import os

import pytest

from slam_bench.tests.tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "lc_crf_slam_tpu"}
OLD_BENCHMARK = ("bench.py", "benchmarks/", "BENCH_r", "MULTICHIP_r")


def sources(sub=""):
    base = os.path.join(BENCH, sub)
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "lc_crf_slam_torch" not in names
    assert names <= {"__future__", "dataclasses", "functools", "math", "typing", "numpy",
                     "torch"}


def test_names_compared_whole():
    # the port's name begins with the JAX package's and is allowed
    assert "lc_crf_slam_torch".split(".")[0] not in FORBIDDEN
    assert "lc_crf_slam_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_old_benchmark_not_read(path):
    with open(path) as fh:
        text = fh.read()
    if os.path.basename(path) == os.path.basename(__file__):
        return
    assert not any(s in text for s in OLD_BENCHMARK)
