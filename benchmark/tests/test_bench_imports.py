"""The reference stands apart from the program, and no run loads JAX."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "bossruns_tpu"}


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program_or_jax():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(f) & (BANNED | {"bossruns_torch"}), f
    code = ("import sys, benchmark.reference.runs, benchmark.reference.dataplane, "
            "benchmark.reference.layout, benchmark.reference.model, benchmark.compare, "
            "benchmark.work; print(sorted({m.split('.')[0] for m in sys.modules}))")
    mods = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, check=True).stdout
    loaded = set(eval(mods))
    assert not loaded & (BANNED | {"bossruns_torch"}), loaded


def test_no_benchmark_file_imports_jax():
    for f in sorted(BENCH.rglob("*.py")):
        assert not _imports(f) & BANNED, f
