"""No module of the harness or the reference imports ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` (compared by whole top-level name:
the port, ``repro_torch``, begins with ``repro``), and the reference
imports nothing of the program."""
import pytest

pytest.importorskip("torch")

import ast  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if not p.name.startswith("test_"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_by_whole_name(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")) + [
            BENCH / "lib" / "check.py", BENCH / "lib" / "weights.py",
            BENCH / "lib" / "modelspec.py"]:
        names = top_level_imports(path)
        assert "repro_torch" not in names, path
        text = path.read_text()
        assert "bench.lib.program" not in text, path
        assert "repro_torch" not in [n for n in names], path


def test_a_run_loads_no_jax():
    """The harness, the program and the reference in one fresh process:
    nothing of JAX is in ``sys.modules`` after."""
    code = ("import sys; sys.argv = ['x']; "
            "sys.path.insert(0, %r); import bench.run as r; "
            "from bench.lib import program; program._import_path(); "
            "import repro_torch.serve, repro_torch.core.factorized; "
            "print(r.forbidden_modules())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
