"""quantnet_torch and chip_smoke.py import neither JAX nor the JAX package."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "quantnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|quantnet)(?:[.\s,]|$)", re.M)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_package_imports_with_jax_blocked():
    """Import every module of the package in a fresh interpreter in which
    importing jax, flax or the JAX package fails."""
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted((ROOT / "quantnet_torch").rglob("*.py"))
    ]
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'quantnet'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
