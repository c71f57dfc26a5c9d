"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package (nor ``ml_dtypes``: the wire codec
carries bf16 through torch), and its entry points never move to
the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))
print('MODULES', len(names))
print('BAD', bad)
assert not bad, bad
assert len(names) >= 20, names
"""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "BAD []" in out.stdout


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
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


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")


def _entry_points():
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.runtime import MeasuredRuntime
    from repro_torch.fed.batch_exec import BatchedExecutor
    from repro_torch.fed.trainer import FedConfig, FederatedTrainer
    from repro_torch.launch.multihost import WorldSpec, run_local_inline
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import init_lm, make_lm_cache
    from repro_torch.models.small import SmallModelConfig, init_small
    from repro_torch.optim.optimizers import make_optimizer

    cfg = SmallModelConfig(hidden=4, n_layers=1, image_size=2)
    lm_cfg = get_config("qwen1.5-0.5b", reduced=True)
    return {
        "init_small": lambda: init_small(0, cfg),
        "BatchedExecutor": lambda: BatchedExecutor(cfg, make_optimizer("sgd", 0.1)),
        "FederatedTrainer": lambda: FederatedTrainer(cfg, [], FedConfig()),
        "MeasuredRuntime": lambda: MeasuredRuntime(),
        "params_from_numpy": lambda: params_from_numpy({"w": np.zeros(2)}),
        "init_lm": lambda: init_lm(torch.Generator(), lm_cfg),
        "make_lm_cache": lambda: make_lm_cache(lm_cfg, 1, 8),
        "serve": lambda: serve(lm_cfg, batch=1, prompt_len=4, decode_steps=1),
        "run_local_inline": lambda: run_local_inline(WorldSpec(n_clients=2, rounds=1,
                                                               participants_per_round=2)),
    }


@pytest.mark.parametrize("name", ["init_small", "BatchedExecutor",
                                  "FederatedTrainer", "MeasuredRuntime",
                                  "params_from_numpy", "init_lm", "make_lm_cache",
                                  "serve", "run_local_inline"])
def test_entry_point_without_device_raises_on_a_cpu_only_host(name):
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_entry_points_run_on_the_cpu_when_asked():
    from repro_torch.models.small import SmallModelConfig, init_small

    from repro_torch.launch.multihost import WorldSpec, run_local_inline

    params = init_small(0, SmallModelConfig(hidden=4, n_layers=1, image_size=2),
                        device="cpu")
    assert params["main"]["head"]["w"].device.type == "cpu"
    trainer = run_local_inline(WorldSpec(n_clients=2, rounds=1, participants_per_round=2),
                               device="cpu")
    assert trainer.device.type == "cpu" and trainer.history[0]["completed"] == 2


def test_kernel_wrappers_take_only_cpu_or_cuda_tensors():
    """The plain version serves CPU tensors only: any other device goes to
    the kernel's checks, which refuse what the kernel cannot take."""
    from repro_torch.kernels.grouped_matmul import ops

    x = torch.empty((4, 3), device="meta")
    w = torch.empty((2, 3, 5), device="meta")
    gs = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gmm(x, w, gs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.tgmm(x, torch.empty((4, 5), device="meta"), gs, 2)
    assert ops.LAUNCHES["gmm"] >= 0 and set(ops.LAUNCHES) == {"gmm", "tgmm"}
