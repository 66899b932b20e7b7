"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro``, top-level names compared whole (``repro_torch``
begins with ``repro``); the plain references import torch alone; the
benchmark reads nothing of ``benchmarks/`` or any ``BENCH_*.json``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchlib import guard, spec

FILES = sorted(p for p in spec.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)
RUNTIME = [p for p in FILES if "tests" not in p.relative_to(spec.BENCH).parts]


def imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.args[0].value


@pytest.mark.parametrize("path", RUNTIME,
                         ids=lambda p: p.relative_to(spec.BENCH).as_posix())
def test_no_forbidden_import(path):
    tops = {m.split(".", 1)[0] for m in imports(path)}
    assert not tops & set(guard.FORBIDDEN), (path, tops)
    text = path.read_text()
    assert "BENCH_" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", sorted(spec.BENCH.glob("configs/*.ref.py")),
                         ids=lambda p: p.name)
def test_references_import_torch_alone(path):
    tops = {m.split(".", 1)[0] for m in imports(path)}
    assert tops <= {"torch", "math", "contextlib", "__future__"}, tops


def test_top_level_names_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reproduce": 1,
            "jaxtyping": 1, "numpy": 1}
    assert guard.forbidden_modules(mods) == []
    mods.update({"repro.core": 1, "jax": 1, "jaxlib.xla": 1, "flax": 1})
    assert guard.forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla",
                                             "repro.core"]


def test_loading_every_cell_loads_no_forbidden_module():
    """A fresh process loads each cell (driver, reference, readers) and
    the program modules the drivers use, then reads sys.modules."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(spec.BENCH)!r}, {str(spec.ROOT / 'src')!r}]\n"
        "from benchlib import guard, spec\n"
        "bench = spec.load_benchmark()\n"
        "for w in bench['workloads']:\n"
        "    spec.load_cell(w['name'])\n"
        "for m in bench['per_layer']:\n"
        "    spec.load_module(spec.metric_path(m['name']))\n"
        "import repro_torch.models.cnn, repro_torch.serving.scheduler\n"
        "import repro_torch.core.coded_linear, repro_torch.dist\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
