"""Import guard: the port (pob_tpu_torch/**.py), its entry module
graft_entry_torch.py and chip_smoke.py import neither jax nor anything of
the JAX package pob_tpu."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "pob_tpu_torch").rglob("*.py")) + [ROOT / "graft_entry_torch.py",
                                                         ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pob_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    assert len(FILES) > 20
    assert (ROOT / "pob_tpu_torch" / "csrc" / "mont.cu").exists()
    for name in ("cli.py", "__main__.py", "prover/serialize.py", "prover/solidity.py",
                 "harness/generate.py", "harness/rlp_host.py", "harness/pow_grind.py",
                 "circuits/spend.py", "dist/__init__.py", "dist/mesh.py", "dist/ntt_sharded.py",
                 "dist/msm_sharded.py", "dist/prove_sharded.py", "dist/pipeline.py",
                 "utils/__init__.py", "utils/metrics.py"):
        assert ROOT / "pob_tpu_torch" / name in FILES, name


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pob_tpu_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
