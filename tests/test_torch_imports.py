"""The port stands on torch alone: nothing in ``src/repro_torch`` or
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``; importing the
port needs neither ``triton`` nor a CUDA compiler; and its entry points
default to the GPU and say so when there is none, instead of quietly
running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "examples" / "torch_coded_cnn.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            # importlib.import_module("jax") / __import__("jax")
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def test_port_files_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("src/repro_torch/kernels/skinny_gemm.py",
                 "src/repro_torch/kernels/conv2d.py",
                 "src/repro_torch/core/coded_conv.py",
                 "src/repro_torch/dist/executor.py",
                 "src/repro_torch/models/cnn.py", "chip_smoke.py",
                 "src/repro_torch/kernels/ssd_chunk.py",
                 "src/repro_torch/models/model.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/telemetry/trace.py",
                 "src/repro_torch/dist/mesh_exec.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/checkpoint/store.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/sharding.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/hlo_analysis.py"):
        assert must in names
    assert (PORT / "kernels" / "csrc" / "skinny_gemm.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "conv2d.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "ssd_chunk.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "ssd_chunk_bwd.cu").is_file()


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(ln, mod) for ln, mod in _imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_import_of_triton_at_module_level(path):
    """A kernel's compiler is imported inside the function that launches
    it; this machine has none and must still import every module.  So is
    msgpack, which only the checkpoint functions need."""
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in ("triton", "msgpack")]


def test_importing_the_port_leaves_jax_out():
    """In a fresh interpreter (this one has imported jax for the parity
    tests): import every module of the port, then look at sys.modules; and
    no module made a process group (the meshes and the dry-run make theirs
    when called)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'triton'})!r})\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'a process group at import'\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


needs_no_gpu = "this check is about a machine without CUDA"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip(needs_no_gpu)
    import numpy as np

    from repro_torch import convert, resolve_device
    from repro_torch.configs import smoke_config
    from repro_torch.models import cnn, model
    from repro_torch.serving import Engine

    gen = torch.Generator().manual_seed(0)
    zamba = smoke_config("zamba2-1.2b")
    for call in (lambda: cnn.init_small_cnn(gen),
                 lambda: cnn.init_vgg16(gen),
                 lambda: cnn.init_resnet18(gen),
                 lambda: cnn.init_cnn(gen, cnn.small_cnn_layers(32)),
                 lambda: convert.cnn_params_from_numpy(
                     {"convs": [np.zeros((1, 1, 3, 3))],
                      "head": np.zeros((1, 1))}),
                 lambda: model.init_params(zamba, gen),
                 lambda: model.init_cache(zamba, 1, 4),
                 lambda: Engine(zamba),
                 lambda: convert.model_params_from_numpy(
                     {"layers": [], "embed": np.zeros((2, 2))}),
                 lambda: resolve_device()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert cnn.init_small_cnn(gen, device="cpu")["head"].device.type == "cpu"


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip(needs_no_gpu)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         text=True, capture_output=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available() is False" in out.stderr


def test_kernel_build_names_follow_the_sources(tmp_path, monkeypatch):
    """The build is keyed by a hash of the source text: nothing is built or
    loaded here (there is no compiler), only the naming is checked."""
    from repro_torch.kernels import _build

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
    seen = set()
    for name in _build.SOURCES:
        src, out = _build._target(name)
        assert src.is_file() and out.parent == tmp_path
        assert out.name.startswith(name + "-") and out.suffix == ".so"
        seen.add(out.name)
    assert len(seen) == len(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    assert _build.build_dir() == ROOT / "build" / "repro_torch_kernels"
    with pytest.raises(RuntimeError, match="kernel source missing"):
        _build._target("no_such_kernel")
