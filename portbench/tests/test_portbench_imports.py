"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program it judges."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deepipr_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path):
    """Every module name an import statement of ``path`` names, and every
    string handed to ``__import__`` or ``import_module``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    # whole top-level names: deepipr_tpu_torch is the port and passes
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


REFERENCE = sorted((HERE / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        top = name.split(".")[0]
        assert top != "deepipr_tpu_torch", name
        if top == "portbench":
            assert name.startswith("portbench.reference"), name


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.resnet, portbench.reference.lower; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert "deepipr_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_guard_names_top_levels_whole():
    from portbench.harness import FORBIDDEN as GUARDED

    assert set(GUARDED) == FORBIDDEN
    assert "deepipr_tpu_torch".split(".")[0] not in GUARDED


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "deepipr_tpu.models"])
def test_a_run_that_loaded_jax_prints_no_result(name, capsys, monkeypatch):
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    code = harness.run(["--workload", "r18v2-f32-infer-private-b1024",
                        "--seed", "1", "--seconds", "0.1"], 0.0,
                       rehearsal=True)
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert name.split(".")[0] in out.err
