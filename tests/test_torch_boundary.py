"""The port's boundaries: what it imports, where it runs, when it launches."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlio_tpu_torch.ops import decode_attention as da
from mlio_tpu_torch.ops import flash_attention as fa
from mlio_tpu_torch.ops import norms

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mlio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                 ROOT / "profile_torch.py",
                                                                 ROOT / "ab_k13.py",
                                                                 ROOT / "ab_k10.py",
                                                                 ROOT / "ab_k6.py"]
NEVER = ("jax", "jaxlib", "mlio_tpu")      # nowhere in the port
LAZY = ("transformers", "safetensors", "triton", "matplotlib")  # only inside functions


def _imports(tree):
    """(module, at module level) for every import statement."""
    top = set(id(n) for n in tree.body)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name, id(node) in top


def _root(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, at_top in _imports(tree):
        assert _root(name) not in NEVER, f"{path.name} imports {name}"
        assert not (at_top and _root(name) in LAZY), f"{path.name} imports {name} at import time"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mlio_tpu_torch.runtime.generate, mlio_tpu_torch.models, "
            "mlio_tpu_torch.ops; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mlio_tpu', 'transformers', 'triton')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr


def test_cpu_tensors_launch_no_kernel():
    before = (fa.flash_attention.launches, norms.fused_norm.launches,
              da.decode_attention.launches)
    q = torch.randn(1, 4, 2, 64)
    fa.flash_attention(q, q, q)
    norms.fused_norm(torch.randn(3, 64), torch.ones(64))
    da.decode_attention(q[:, 0], torch.randn(1, 1, 4, 2, 64), torch.randn(1, 1, 4, 2, 64),
                        torch.tensor([2], dtype=torch.int32), layer=0)
    assert (fa.flash_attention.launches, norms.fused_norm.launches,
            da.decode_attention.launches) == before


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        norms.fused_norm(q, torch.empty(64, device="meta"))


def test_entry_points_default_to_the_card():
    from mlio_tpu_torch.models import load_model
    from mlio_tpu_torch.runtime import generate, init_cache

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("gpt2-tiny")
    spec, params = load_model("gpt2-tiny", dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(spec, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(params, spec, torch.zeros(1, 3, dtype=torch.long), max_new_tokens=2)
