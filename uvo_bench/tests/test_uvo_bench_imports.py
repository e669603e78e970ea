"""Nothing of the benchmark imports JAX or the JAX package, and its plain
reference imports nothing of the port: top-level names compared whole."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ergo_uvo_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    found = [(str(p.relative_to(BENCH)), name) for p in sorted(BENCH.rglob("*.py"))
             for name in _imports(p) if name in FORBIDDEN]
    assert not found


def test_reference_imports_nothing_of_the_port():
    found = [(str(p.relative_to(BENCH)), name)
             for p in sorted((BENCH / "reference").rglob("*.py"))
             for name in _imports(p) if name in FORBIDDEN | {"ergo_uvo_tpu_torch"}]
    assert not found


def test_the_comparison_is_by_whole_top_level_name():
    tree = "import ergo_uvo_tpu_torch.pipeline\nfrom ergo_uvo_tpu_torch import config\n"
    path = BENCH.parent / "build" / "uvo_bench_import_probe.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(tree)
    try:
        assert set(_imports(path)) == {"ergo_uvo_tpu_torch"}
        assert not set(_imports(path)) & FORBIDDEN
    finally:
        path.unlink()


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from uvo_bench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "ergo_uvo_tpu_torch_probe", types.ModuleType("p"))
    assert run.forbidden_modules() == ["jax.numpy"]
