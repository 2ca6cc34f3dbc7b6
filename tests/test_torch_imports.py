"""The port stands alone: it never imports jax or the JAX package, and on
the card path nothing quietly runs on the host."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import consensus_specs_tpu_torch as port
from consensus_specs_tpu_torch.ssz import merkle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "consensus_specs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "consensus_specs_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(PORT_DIR):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import consensus_specs_tpu_torch, consensus_specs_tpu_torch.convert\n"
        "import consensus_specs_tpu_torch.ops.sha256_cuda\n"
        "import consensus_specs_tpu_torch.ops.epoch_sweep_cuda\n"
        "import consensus_specs_tpu_torch.specs.epoch_fast\n"
        "from consensus_specs_tpu_torch.ops import cuda_build\n"
        "from consensus_specs_tpu_torch.specs import get_spec\n"
        "get_spec('phase0', 'minimal')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'consensus_specs_tpu')]\n"
        "print(bad, cuda_build.build_route)\n"
        "sys.exit(1 if bad or cuda_build._kernels is not None else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_file_imports_jax_or_the_reference(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_without_a_card_raises(monkeypatch):
    """With the default device and no card, the first big level raises a
    RuntimeError instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port.set_device("cuda")
    try:
        merkle.use_device_hashing()
        chunks = [bytes([i % 256]) * 32 for i in range(2 * 2048)]
        with pytest.raises(RuntimeError, match="set_device"):
            merkle.merkleize_chunks(chunks)
        with pytest.raises(RuntimeError, match="set_device"):
            merkle.merkleize_chunks(chunks * 4)   # the subtree hasher
    finally:
        port.set_device("cpu")
