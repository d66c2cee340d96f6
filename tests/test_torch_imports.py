"""The port stands alone: ``import repro_torch`` loads neither JAX nor
any module of the ``repro`` package, no source file of the port (or
chip_smoke.py, or a script under tools/) imports them, and every entry
point refuses to fall back to the CPU without being asked."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_import_loads_no_jax_and_no_repro():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("package", ["repro_torch", "repro_torch.serve",
                                     "repro_torch.runtime.trace",
                                     "repro_torch.runtime.metrics"])
def test_package_alone_loads_no_jax_and_no_repro(package):
    """``import repro_torch``, ``import repro_torch.serve`` (the server,
    the broker and the resilience layer, copies of ``repro.serve``) and
    the observability modules, each in a fresh interpreter."""
    code = (f"import {package}, sys\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_neither_jax_nor_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.config import ProxyConfig
    from repro_torch.config import CascadeConfig
    from repro_torch.core import scoring
    from repro_torch.core.pipeline import ScaleDocPipeline
    from repro_torch.core.trainer import (train_proxy, train_proxy_multi,
                                          train_proxy_variant)
    from repro_torch.engine import ScaleDocEngine, ScoringExecutor
    from repro_torch.kernels.fused_scoring import ops
    from repro_torch.runtime.serve_loop import EmbeddingService
    docs = np.zeros((80, 8), np.float32)
    cfg = ProxyConfig(embed_dim=8, hidden_dim=8, latent_dim=8, proj_dim=4)
    calls = [
        lambda: ScaleDocEngine(docs),
        lambda: ScaleDocPipeline(docs, cfg, CascadeConfig()),
        lambda: ScoringExecutor(),
        lambda: train_proxy(0, docs[0], docs, np.ones(80), cfg),
        lambda: train_proxy_multi([0], docs[:1], [docs], [np.ones(80)], cfg),
        lambda: train_proxy_variant(0, docs[0], docs, np.ones(80), cfg,
                                    "qsim"),
        lambda: train_proxy_variant(0, docs[0], docs, np.ones(80), cfg,
                                    "mlp"),
        lambda: scoring.score_collection({}, docs[0], docs),
        lambda: scoring.direct_embedding_scores(docs[0], docs),
        lambda: ops.score_collection({}, docs[0], docs),
        lambda: EmbeddingService(None, {}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ScoringExecutor(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "tests").glob("test_torch_*.py")
    if p.name != "test_torch_cuda.py"))
def test_cpu_tests_import_nothing_from_the_card_tests(path):
    """The CPU parity tests take their shared inputs and tolerances from
    tests/torch_kernel_inputs.py, never from the card tests' module."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert "test_torch_cuda" not in names, path
