"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the
program."""
import ast

from benchutil import BENCH

JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not set(_imports(p)) & JAX, p


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "mrabench" / "reference").rglob("*.py"):
        assert not set(_imports(p)) & (JAX | {"repro_torch"}), p


def test_run_time_guard_compares_whole_names():
    from mrabench import cli

    assert cli.forbidden_modules(["repro_torch.kernels", "numpy"]) == []
    assert cli.forbidden_modules(["repro.core.mra", "jax"]) == ["jax",
                                                               "repro"]
