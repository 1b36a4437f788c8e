"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, importing the port leaves
``jax`` unloaded, and the entry points run on the card unless the caller
asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hfl as TH  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(BANNED))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.core.experiment' in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_without_cuda_raises(monkeypatch):
    """No silent CPU fallback: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tuple(np.zeros(s, np.float32) for s in ((4, 2, 3), (4, 2, 3),
                                                   (4,)))
    with pytest.raises(RuntimeError, match="cuda"):
        TH.FederatedClient("h", 2, TH.HFLConfig(), data, data, data)
    client = TH.FederatedClient("h", 2, TH.HFLConfig(), data, data, data,
                                device="cpu")
    assert client.params["heads"]["w0"].device.type == "cpu"


def test_fp32_products_are_not_tf32():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
