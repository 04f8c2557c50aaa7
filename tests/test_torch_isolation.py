"""The PyTorch port stands alone: importing it (and its chip check) pulls in
neither JAX nor any module of the reference package, and its entry points
refuse to fall back to the CPU when CUDA is absent.  The import check runs
in a subprocess because this test process imports JAX (conftest)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import repro_torch, repro_torch.engine, repro_torch.covariance, repro_torch.kernels.build
import repro_torch.stream, repro_torch.select, repro_torch.kernels.threshold_cc
import repro_torch.kernels.covgram_screen
import repro_torch.joint, repro_torch.kernels.joint_prox, repro_torch.stream.unionfind
import repro_torch.kernels.prox_l1, repro_torch.kernels.shard_prox, repro_torch.core.distributed
import repro_torch.core.solvers.pg, repro_torch.core.solvers.admm, repro_torch.core.solvers.sharded
import repro_torch.kernels.covgram, repro_torch.core.sparse, repro_torch.core.solvers.kkt
import repro_torch.covariance.estimators, repro_torch.covariance.synthetic, repro_torch.joint.blocks
import repro_torch.kernels.flash_attention, repro_torch.configs, repro_torch.configs.base
import repro_torch.models.layers, repro_torch.models.attention, repro_torch.models.transformer
import repro_torch.models.moe
import repro_torch.models.zoo, repro_torch.models.convert, repro_torch.data.specs
import repro_torch.train.serving, repro_torch.launch.serve
import repro_torch.engine.planner, repro_torch.engine.executor, repro_torch.stream.path
import repro_torch.engine.waves, repro_torch.core.blocks, repro_torch.core.partition
import repro_torch.select.grid, repro_torch.select.homotopy, repro_torch.select.criteria
import repro_torch.select.report, repro_torch.select.cv, repro_torch.select.stability
import repro_torch.stream.session, repro_torch.launch.control_plane
import repro_torch.launch.serve_glasso, repro_torch.launch
import repro_torch.core.schedule, repro_torch.core.components, repro_torch.engine.registry
import repro_torch.engine.api, repro_torch.stream.materialize, repro_torch.kernels.threshold_cc.ops
import repro_torch.kernels.threshold_cc.ref, repro_torch.kernels.flash_attention.ops
repro_torch.launch.GlassoServer, repro_torch.launch.DenseSpec
import repro_torch.models, repro_torch.optim, repro_torch.optim.adamw, repro_torch.optim.adafactor
import repro_torch.optim.schedule, repro_torch.optim.grad_compress, repro_torch.data.synthetic_lm
import repro_torch.train.tree, repro_torch.train.state, repro_torch.train.step
import repro_torch.checkpoint, repro_torch.checkpoint.io, repro_torch.launch.train
repro_torch.kernels.tree_glasso.glasso_forest
for arch in repro_torch.configs.list_archs():
    repro_torch.configs.get_arch(arch)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(repr(bad))
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    S = np.eye(3) + 0.5 * (np.ones((3, 3)) - np.eye(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.glasso(S, 0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.Engine()
    r = repro_torch.glasso(S, 0.1, options=repro_torch.EngineOptions(device="cpu"))
    assert r.device == "cpu" and np.isfinite(r.Theta).all()


def test_serving_defaults_to_cuda_and_never_falls_back(monkeypatch):
    from repro_torch.launch.serve import run_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_serving(arch="qwen2_5_3b", batch=1, prompt_len=4, new_tokens=1)
    run = run_serving(arch="qwen2_5_3b", batch=1, prompt_len=4, new_tokens=1,
                      device="cpu", log=lambda _: None)
    assert run.tokens.shape == (1, 1) and run.model.device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA the chip check exits nonzero and prints no result; copied
    alone, without the package, it cannot even import."""
    code = (
        "import sys, torch; torch.cuda.is_available = lambda: False; "
        "sys.argv = ['chip_smoke.py']; import runpy; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH")
    proc = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
