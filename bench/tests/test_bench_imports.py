"""Nothing under bench/ imports JAX or the JAX package; the reference imports
nothing of the port."""
import ast
from bench.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((REPO / "bench").rglob("*.py"))
    assert files
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_torch_alone():
    for path in (REPO / "bench/reference").glob("*.py"):
        assert top_level_imports(path) <= {"__future__", "contextlib", "typing", "torch"}, path


def test_harness_reads_nothing_under_benchmarks():
    for path in (REPO / "bench").rglob("*.py"):
        assert "benchmarks/" not in path.read_text() or path.name.startswith("test_bench"), path


def test_forbidden_modules_compares_whole_names():
    from bench.harness.cli import forbidden_modules
    names = ["repro_torch", "repro_torch.models", "reprox", "jaxlib.xla", "flax", "repro.kernels"]
    assert forbidden_modules(names) == ["flax", "jaxlib", "repro"]
    assert forbidden_modules(["repro_torch.serve", "numpy", "torch"]) == []
