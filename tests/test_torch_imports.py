"""The port imports neither JAX nor the JAX package.

A fresh interpreter (this test process has imported both, through
``tests/conftest.py``) imports every module of ``mpinets_torch`` and
``chip_smoke`` (without running its ``main``), then lists what it loaded;
once more with ``h5py`` blocked, as on a machine without it.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = f"""
import importlib, pkgutil, sys
BLOCK_H5PY
sys.path.insert(0, {str(REPO)!r})
import mpinets_torch
names = sorted(m.name for m in pkgutil.walk_packages(mpinets_torch.__path__, "mpinets_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
assert chip_smoke.__file__.startswith({str(REPO)!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mpinets_tpu"))
print(len(names), bad)
"""


def _run(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)


def test_port_and_chip_smoke_import_no_jax():
    out = _run(SCRIPT.replace("BLOCK_H5PY", ""))
    assert out.returncode == 0, out.stderr[-3000:]
    count, bad = out.stdout.split(maxsplit=1)
    assert int(count) >= 40, out.stdout   # every module was found and imported
    assert bad.strip() == "[]", f"imported: {bad}"


def test_port_imports_without_h5py():
    """The card's machine has no h5py: with it blocked, every module of the
    port (the data tools among them) and ``chip_smoke`` still import."""
    out = _run(SCRIPT.replace("BLOCK_H5PY", 'sys.modules["h5py"] = None'))
    assert out.returncode == 0, out.stderr[-3000:]
    count, bad = out.stdout.split(maxsplit=1)
    assert int(count) >= 40, out.stdout
    assert bad.strip() == "[]", f"imported: {bad}"
