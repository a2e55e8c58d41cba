"""Import boundary of the PyTorch port.

``imaginaire_tpu_torch`` and ``chip_smoke.py`` must never import JAX,
Flax or the JAX package (not even its yaml-only modules), and the
package must import on a machine with no CUDA toolkit and no Triton:
kernels are built at first use, never at import. The GPU machine also
has no OpenCV, PIL, torchvision, TensorBoard, LMDB or scikit-learn
(pix2pixHD's K-means is the port's own): no port file
imports them, except one lazy OpenCV import, named below, in the branch
that decodes JPEG (and other formats the port's PNG codec does not
read).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "imaginaire_tpu")
PORT_FILES = sorted((REPO / "imaginaire_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))
GPU_MACHINE_LACKS = ("cv2", "PIL", "torchvision", "tensorboard", "lmdb", "sklearn")
# (file, function) of the one allowed import of any of them
LAZY_OPENCV_IMPORT = ("imaginaire_tpu_torch/data/backends.py", "_decode_with_opencv")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _scoped_imports(path):
    """(module, enclosing function or None) of every import in ``path``."""
    found = []

    def visit(node, scope):
        if isinstance(node, ast.Import):
            found.extend((alias.name, scope) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append((node.module, scope))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = node.name
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    visit(ast.parse(path.read_text(), filename=str(path)), None)
    return found


def _lacking(module):
    return module.split(".")[0] in GPU_MACHINE_LACKS or "tensorboard" in module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_the_gpu_machine_lacks(path):
    rel = str(path.relative_to(REPO))
    bad = [(m, scope) for m, scope in _scoped_imports(path)
           if _lacking(m) and (rel, scope) != LAZY_OPENCV_IMPORT]
    assert not bad, f"{rel} imports {bad}"


def test_the_lazy_opencv_import_is_the_named_one():
    rel, function = LAZY_OPENCV_IMPORT
    assert [m for m, scope in _scoped_imports(REPO / rel)
            if _lacking(m)] == ["cv2"]
    assert [scope for m, scope in _scoped_imports(REPO / rel) if m == "cv2"] == [function]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_package_imports_without_nvcc_or_triton(tmp_path):
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['triton'] = None\n"  # any `import triton` now raises
        "for name in ('cv2', 'PIL', 'torchvision', 'tensorboard', 'lmdb'):\n"
        "    sys.modules[name] = None\n"
        "import imaginaire_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'imaginaire_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from imaginaire_tpu_torch.ops import build\n"
        "print(len(names), build.BUILD_DIR.exists())\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(REPO))
    env.pop("CUDA_PATH", None)
    before = sorted(REPO.glob("imaginaire_tpu_torch/build/*.so"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 10
    assert sorted(REPO.glob("imaginaire_tpu_torch/build/*.so")) == before
