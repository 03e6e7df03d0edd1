"""Rules of the port: nothing in ``src/repro_torch/`` or ``chip_smoke.py``
imports jax or the JAX package; importing the port leaves jax unloaded;
and asking for CUDA where torch sees no GPU raises instead of quietly
running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.kernels.ops, "
            "repro_torch.models, repro_torch.core, repro_torch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("torch sees a GPU here; the rule is about machines "
                    "without one")
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.layers.attention import init_paged_kv_cache
    from repro_torch.layers.common import resolve_device
    from repro_torch.models import lm_init
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.block_manager import init_paged_cache

    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    tree = {"embed": {"table": params["embed"]["table"].numpy()},
            "segments": [{}], "final_norm": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    # the entry points default to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, batch_size=2, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    vcfg = reduced(get_config("soft-moe-s/16-128e"))
    vtree = {"patch_proj": {"b": np.zeros(vcfg.d_model, np.float32)},
             "segments": [{}, {}], "final_norm": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(vtree, vcfg)
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data import SyntheticImages

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_jax({"params": vtree, "opt": {
            "mu": vtree, "nu": vtree, "step": np.int32(0)}}, vcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticImages(num_patches=4, patch_dim=8, batch_size=2)
    # the pool initialisers take no default device, and refuse CUDA
    for init in (init_paged_kv_cache, init_paged_cache):
        with pytest.raises(TypeError, match="device"):
            init(cfg, 4, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(cfg, 4, 4, device="cuda")


def test_unported_engine_options_raise():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm_init
    from repro_torch.serve import ServeEngine

    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    for kw in ({"spec": object()}, {"trace": True}, {"telemetry": True},
               {"flight_recorder": 4}, {"backend": "contiguous"}):
        with pytest.raises(NotImplementedError):
            ServeEngine(cfg, params, batch_size=2, max_len=32, device="cpu",
                        **kw)
    with pytest.raises(NotImplementedError):
        lm_init(torch.Generator(), reduced(get_config("qwen2-0.5b+soft")))


def test_unported_moe_options_raise():
    """K6 telemetry, the sparse variants and MoE LMs are not ported, and a
    raw kernel has no backward of its own (the autograd Functions of
    kernels/ops.py carry the gradient): each refuses, never runs half."""
    from repro_torch.configs import MoEConfig, get_config, reduced
    from repro_torch.core import moe_apply, moe_init, soft_moe_apply
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_online,
        routing_fwd,
    )
    from repro_torch.models import lm_init

    gen = torch.Generator().manual_seed(0)
    cfg = MoEConfig(variant="soft", num_experts=4, expert_d_ff=8)
    params = moe_init(gen, 16, cfg)
    x = torch.randn(2, 5, 16)
    with pytest.raises(NotImplementedError, match="telemetry"):
        soft_moe_apply(params, cfg, x, telemetry=True)
    for variant in ("tokens_choice", "experts_choice", "identity",
                    "uniform", "soft_uniform", "uniform_soft"):
        other = MoEConfig(variant=variant, num_experts=4, expert_d_ff=8)
        with pytest.raises(NotImplementedError, match="not ported"):
            moe_init(gen, 16, other)
        with pytest.raises(NotImplementedError, match="not ported"):
            moe_apply(params, other, x)
    with pytest.raises(NotImplementedError):
        lm_init(torch.Generator(),
                reduced(get_config("granite-moe-1b-a400m+soft")))

    # A kernel wrapper handed non-CPU tensors that need a gradient refuses
    # before anything else (differentiate through kernels/ops.py instead);
    # "meta" tensors stand in for CUDA ones on a machine without a card.
    meta = dict(device="meta")
    xm = torch.empty(2, 8, 16, **meta).requires_grad_()
    phi = torch.empty(16, 4, **meta)
    ys = torch.empty(2, 4, 16, **meta)
    stats = (torch.empty(2, 8, **meta), torch.empty(2, 8, **meta))
    for call in (lambda: routing_fwd(xm, phi),
                 lambda: combine_apply(xm, phi, ys, stats),
                 lambda: combine_online(xm, phi, ys)):
        with pytest.raises(NotImplementedError, match="kernels/ops.py"):
            call()
