"""Guards of the port: imports, device selection, and the CPU CLI."""
import ast
import json
import pathlib

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.configs import dcn_ctr
from repro_torch.launch import serve
from repro_torch.training.ctr_trainer import TrainerConfig, init_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference():
    sources = _port_sources()
    assert len(sources) > 20 and all(p.is_file() for p in sources)
    bad = {
        f"{p.relative_to(ROOT)} imports {root}"
        for p in sources for root in _imported_roots(p) if root in FORBIDDEN
    }
    assert not bad, sorted(bad)


def test_import_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import quant\n"
                     "from repro_torch.core import quant as q\nfrom . import x\n")
    assert [r for r in _imported_roots(probe) if r in FORBIDDEN] == ["jax", "repro"]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_entry_points_refuse_cuda_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.resolve("cuda")
    _, spec, dcn = dcn_ctr.avazu_setup(scale=0.001)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(TrainerConfig(spec=spec, dcn=dcn))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["ctr", "--scale", "0.001", "--requests", "4"])


def test_resolve_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert device_mod.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("method,bits", [("alpt", 8), ("lpt", 4)])
def test_cli_serves_on_cpu(capsys, method, bits):
    rc = serve.main(["ctr", "--config", "avazu", "--scale", "0.001", "--method", method,
                     "--bits", str(bits), "--batch", "16", "--requests", "40",
                     "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    m = json.loads(lines[-1])
    assert m["requests_completed"] == 40 and m["steps"] == 3 and m["int8_resident"]
    n = 4416  # avazu_like(0.001).n_features
    assert m["embedding_scale_bytes"] == n * 4
    assert m["embedding_code_bytes"] == n * (16 if bits == 8 else 8)
    assert m["kernel_launches"] == {}
