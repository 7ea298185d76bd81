"""The PyTorch port stands alone: no file of pilosa_tpu_torch/ nor
chip_smoke.py imports jax or the JAX package, and the device backend
refuses to start without a card unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pilosa_tpu")


def _port_files():
    files = sorted((ROOT / "pilosa_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_has_files():
    files = _port_files()
    assert len(files) > 30 and all(f.exists() for f in files)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _module_exists(name):
    path = ROOT.joinpath(*name.split("."))
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_name_existing_or_queued_modules(path):
    """Every pilosa_tpu_torch.* module an import of the port names, lazy
    ones included, exists: no module is queued any more."""
    missing = sorted(
        m for m in set(_imported_modules(path))
        if m.split(".")[0] == "pilosa_tpu_torch" and not _module_exists(m)
    )
    assert not missing, f"{path.relative_to(ROOT)} imports missing modules {missing}"


def _named_port_modules():
    """Every pilosa_tpu_torch module that an import of the port names."""
    names = set()
    for path in _port_files():
        for m in _imported_modules(path):
            if m.split(".")[0] == "pilosa_tpu_torch":
                names.add(m)
    return sorted(names)


@pytest.mark.parametrize("name", _named_port_modules())
def test_every_named_port_module_imports(name):
    """Each module that code of the port imports, lazily or not, imports:
    none dangles (the cluster layer's lazy imports of
    cluster.sync, cluster.resize and cluster.consistency once did)."""
    import importlib

    assert importlib.import_module(name).__name__ == name


def test_devtrace_is_scanned_and_imports_without_side_effects():
    """utils/devtrace.py is among the scanned files and the imported
    modules; importing it starts no thread, imports no torch.profiler and
    leaves no trace live."""
    import subprocess
    import sys

    assert ROOT / "pilosa_tpu_torch" / "utils" / "devtrace.py" in _port_files()
    assert "pilosa_tpu_torch.utils.devtrace" in _named_port_modules()
    code = ("import sys, threading; import pilosa_tpu_torch.utils.devtrace as d; "
            "print(threading.active_count(), 'torch.profiler' in sys.modules, d._LIVE)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "False", "None"]


def test_scanner_sees_lazy_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "def f():\n    from pilosa_tpu.store import attrs\n"
        "    import jax.numpy\n    __import__('jaxlib')\n"
    )
    mods = list(_imported_modules(src))
    assert mods == ["pilosa_tpu.store", "jax.numpy", "jaxlib"]


def test_backend_without_device_raises_when_no_card(monkeypatch):
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec.cuda import CUDABackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = Holder(None).open()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDABackend(h)
    assert CUDABackend(h, device="cpu").device.type == "cpu"


def test_executor_defaults_to_card_backend(monkeypatch):
    """Executor(holder), the entry point's default, builds the CUDA
    backend: with no card it raises instead of serving from the CPU."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.exec import Executor
    from pilosa_tpu_torch.exec.cpu import CPUBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = Holder(None).open()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(h)
    assert isinstance(Executor(h, backend=CPUBackend(h)).backend, CPUBackend)


def test_kernels_have_no_cpu_build():
    """A CUDA tensor never reaches a plain version: the wrapper on a
    non-CPU, non-CUDA device raises instead of carrying on."""
    from pilosa_tpu_torch.ops import kernels as K

    x = torch.zeros((1, 8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.pair_stats_pershard(x, x)
