"""The port stands alone: no module of sdrjfm_tpu_torch, and not
chip_smoke.py, imports jax or sdrjfm_tpu; importing the CLI module leaves
jax out of sys.modules; importing any module builds and launches nothing."""

import ast
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
            "sdrjfm_tpu_torch.runtime.stream; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sdrjfm_tpu', 'triton')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
