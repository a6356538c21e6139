"""The port stands alone: no module of sdrjfm_tpu_torch, and not
chip_smoke.py, imports jax or sdrjfm_tpu; importing the CLI module leaves
jax out of sys.modules; importing any module builds and launches nothing.
No port source uses a path into sdrjfm_tpu/ (the native ingest sources do
not even name one), and the ingest library is built and loaded from under
sdrjfm_tpu_torch/ only."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "sdrjfm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "sdrjfm_tpu"), (path, mod)


def test_cli_import_pulls_in_no_jax():
    code = ("import sys, sdrjfm_tpu_torch.app, sdrjfm_tpu_torch.convert, "
            "sdrjfm_tpu_torch.runtime.stream, "
            "sdrjfm_tpu_torch.runtime.native_source, "
            "sdrjfm_tpu_torch.io.source; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sdrjfm_tpu', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# The port builds and loads nothing of the JAX package
# ---------------------------------------------------------------------------

PORT = ROOT / "sdrjfm_tpu_torch"
JAX_PATH = re.compile(r"sdrjfm_tpu(?!_torch)\b/?")
NATIVE = sorted(p for p in PORT.rglob("*")
                if p.is_file() and "_build" not in p.parts
                and (p.suffix in (".cc", ".h") or p.name == "Makefile"))


def _code_strings(path: Path):
    """The string constants of a module, docstrings left out (they may
    cite the JAX package's files)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


def test_native_sources_exist_and_name_no_jax_package_path():
    assert {p.name for p in NATIVE} == {"ingest.cc", "ringbuffer.h",
                                        "sdrplay_abi.h", "Makefile"}
    for p in NATIVE:
        assert not JAX_PATH.search(p.read_text()), p


@pytest.mark.parametrize("path", FILES[:-1],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_uses_a_jax_package_path(path):
    for s in _code_strings(path):
        assert not JAX_PATH.search(s), (path, s)


def test_cuda_sources_include_nothing_outside_the_port():
    for p in sorted((PORT / "csrc").glob("*.cu")):
        for line in p.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not JAX_PATH.search(line) and ".." not in line, (p,
                                                                         line)


def test_ingest_library_builds_and_loads_under_the_port():
    from sdrjfm_tpu_torch.runtime import native_source as N
    assert N.NATIVE_DIR.is_relative_to(PORT)
    assert N.library_path().is_relative_to(PORT / "kernels" / "_build")
    lib = N.load_library()
    assert Path(lib._name).resolve() == N.library_path().resolve()
    r = subprocess.run(["git", "check-ignore", "-q",
                        str(N.library_path().relative_to(ROOT))], cwd=ROOT)
    assert r.returncode == 0, "the build directory is not gitignored"
