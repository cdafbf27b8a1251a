"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package ``repro``, and the
port's entry points do not fall back to the CPU unasked."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError

class RefuseReference:
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"repro_torch imported the reference package: {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items()
                if mod is not None and (m == "repro" or m.startswith(("repro.", "jax"))))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25  # every module was imported


IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s+import))",
    re.MULTILINE,
)


def test_no_jax_or_reference_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 27
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in IMPORT_RE.finditer(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch.config import get_arch
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3.2-1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, device="cuda")
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    assert model.device == torch.device("cpu")
