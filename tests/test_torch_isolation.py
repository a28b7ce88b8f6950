"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
never drop to the CPU unasked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20 and files[-1].exists()
    names = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"models/mamba.py", "models/moe.py", "kernels/ssm_scan/ops.py",
            "kernels/moe_gating/ops.py", "kernels/transform/ops.py"} <= names
    return files


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "n = sum(1 for n in sys.modules if n.startswith('repro_torch'))\n"
        "print(n, bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout


def test_entry_points_default_to_cuda_or_raise():
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import ServeEngine
    cfg = ModelConfig(arch_id="t", family="dense", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=32)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        with pytest.raises(ValueError, match="one device"):
            ServeEngine(cpu_model, params)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cpu_model, params)
