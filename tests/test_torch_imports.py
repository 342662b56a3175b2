"""The PyTorch port imports nothing of JAX, pandas or the JAX package,
and its entry points refuse to run on a missing GPU instead of falling
back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "microrank_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pandas", "microrank_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "step_design_probe.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_whole_port_imports_without_jax_or_pandas():
    # jax and pandas are poisoned: any import of either raises.
    code = f"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["pandas"] = None
sys.path.insert(0, {str(ROOT)!r})
import microrank_tpu_torch
for m in pkgutil.walk_packages(microrank_tpu_torch.__path__, "microrank_tpu_torch."):
    importlib.import_module(m.name)
import microrank_tpu_torch.cli
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(
    m for m in sys.modules
    if m == "microrank_tpu" or m.startswith("microrank_tpu.")
)
assert not loaded, loaded
print("port modules:", sum(m.startswith("microrank_tpu_torch") for m in sys.modules))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split(":")[-1])
    assert n >= 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from microrank_tpu_torch import cli
    from microrank_tpu_torch.pipeline import TableRCA, run_rca_native
    from microrank_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TableRCA()
    data = ROOT / "tests" / "data" / "otel_demo"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_rca_native(data / "normal.csv", data / "abnormal.csv")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([
            "run", "--normal", str(data / "normal.csv"),
            "--abnormal", str(data / "abnormal.csv"), "-o", str(tmp_path),
        ])
    # Asked for explicitly, the CPU is fine.
    assert TableRCA(device="cpu").device == torch.device("cpu")


def test_unported_kernels_raise():
    from microrank_tpu.config import PageRankConfig as JaxPageRank
    from microrank_tpu.config import RuntimeConfig as JaxRuntime
    from microrank_tpu_torch.config import PageRankConfig, RuntimeConfig

    # Every kernel JAX runs is ported, csr, coo and dense too; a name no
    # package runs raises.
    for kernel in ("csr", "coo", "dense", "dense_bf16"):
        assert RuntimeConfig(kernel=kernel).kernel == JaxRuntime(kernel=kernel).kernel == kernel
    with pytest.raises(ValueError, match="unknown kernel"):
        RuntimeConfig(kernel="sparse")
    # Every kind precision JAX runs is ported (int8 since the K2-int8
    # slice); an unknown one raises in both packages.
    for precision in ("f32", "bf16", "int8"):
        assert PageRankConfig(kind_precision=precision).kind_precision == (
            JaxPageRank(kind_precision=precision).kind_precision
        )
    with pytest.raises(ValueError, match="kind_precision"):
        PageRankConfig(kind_precision="fp8")
    # Every kernel JAX's auto can pick is accepted, as in JAX.
    for kernel in ("auto", "kind", "packed", "packed_bf16", "packed_blocked", "pcsr", "pallas"):
        assert RuntimeConfig(kernel=kernel).kernel == JaxRuntime(kernel=kernel).kernel == kernel
    assert RuntimeConfig().kernel == "auto" and RuntimeConfig().prefer_bf16
    assert PageRankConfig().kind_precision == "f32"
    assert PageRankConfig().packed_block_bytes == JaxPageRank().packed_block_bytes


def test_chip_smoke_refuses_without_cuda_or_port(tmp_path):
    # Run alone (a directory holding chip_smoke.py and nothing else of
    # the repo) it must fail and print no result, card or no card.
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, str(alone)], capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path),
    )
    assert out.returncode != 0
    assert out.stdout == ""
