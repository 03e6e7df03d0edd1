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
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.core.inspection, repro_torch.serve.telemetry, "
            "repro_torch.core.sparse_moe, repro_torch.core.ablations, "
            "repro_torch.serve.server, repro_torch.serve.faults, "
            "repro_torch.serve.spec_decode, repro_torch.serve.exporter, "
            "repro_torch.distributed.a2a_routing, "
            "repro_torch.distributed.compat, repro_torch.launch.mesh, "
            "repro_torch.optim.compression, repro_torch.roofline.flops, "
            "repro_torch.roofline.analysis, "
            "repro_torch.roofline.collectives, repro_torch.launch.specs, "
            "repro_torch.launch.dryrun, repro_torch.launch.hillclimb; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(); "
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
    from repro_torch.serve import WaveEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveEngine(cfg, params, batch_size=2, max_len=32)
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
    from repro_torch.data import SyntheticLM

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(vocab_size=16, seq_len=4, batch_size=2)
    # the pool and cache initialisers take no default device, and refuse
    # CUDA
    from repro_torch.layers.attention import init_kv_cache
    from repro_torch.models import init_cache, init_encdec_cache
    from repro_torch.serve import CachePool

    for init in (init_paged_kv_cache, init_paged_cache, init_cache,
                 init_encdec_cache, CachePool,
                 lambda *a, **kw: init_kv_cache(*a, True, **kw)):
        with pytest.raises(TypeError, match="device"):
            init(cfg, 4, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(cfg, 4, 4, device="cuda")
    # the contiguous backend's engine and the seq2seq stream default to
    # the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, batch_size=2, max_len=32,
                    backend="contiguous")
    from repro_torch.data import SyntheticSeq2Seq

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticSeq2Seq(vocab_size=16, seq_len=4, num_frames=2,
                         frame_dim=3, batch_size=2)


def test_unported_engine_options_raise():
    """The serving options the last slices ported build what the
    reference builds: ``spec``, ``trace`` and ``flight_recorder`` on both
    backends and ``cache_generated`` on the paged one (the contiguous
    backend refuses it, as in the reference), and ``spec`` refuses an SSM
    arch and a wrapping contiguous ring with the reference's
    ``ValueError``. ``lm_init`` and ``ServeEngine`` take
    seamless-m4t-large-v2 (its decoder stack with the audio frontend
    prepended), and MLA runs on the contiguous ring cache."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm_apply, lm_init
    from repro_torch.serve import (
        ContiguousBackend,
        FlightRecorder,
        PagedBackend,
        ServeEngine,
        SpecConfig,
        Tracer,
    )

    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    geo = dict(batch_size=2, max_len=32, device="cpu")
    for backend, cls in (("contiguous", ContiguousBackend),
                         ("paged", PagedBackend)):
        eng = ServeEngine(cfg, params, backend=backend, spec=SpecConfig(k=2),
                          trace=True, flight_recorder=4, **geo)
        assert isinstance(eng.backend, cls)
        assert eng.spec_stats()["verify_calls"] == 0
        assert isinstance(eng.tracer, Tracer)
        assert isinstance(eng.recorder, FlightRecorder)
        assert eng.recorder.capacity == 4
        assert eng.config_info()["spec"] == "on"
    eng = ServeEngine(cfg, params, backend="paged", cache_generated=True,
                      **geo)
    assert eng.backend.cache_generated
    with pytest.raises(ValueError, match="paged backend"):
        ServeEngine(cfg, params, cache_generated=True, **geo)
    mamba = reduced(get_config("mamba2-370m"))
    with pytest.raises(ValueError, match="SSM state advanced by a rejected"):
        ServeEngine(mamba, lm_init(torch.Generator().manual_seed(0), mamba),
                    backend="paged", spec=SpecConfig(k=2), **geo)
    gemma = reduced(get_config("gemma3-27b"))  # window 16 < max_len 32
    with pytest.raises(ValueError, match="non-wrapping rings"):
        ServeEngine(gemma, lm_init(torch.Generator().manual_seed(0), gemma),
                    spec=SpecConfig(k=2), **geo)
    # seamless-m4t-large-v2: lm_init draws the embedding, the audio
    # frontend's projection and the decoder stack, and the (default,
    # contiguous) engine serves it
    seamless = reduced(get_config("seamless-m4t-large-v2"))
    sp = lm_init(torch.Generator().manual_seed(0), seamless)
    fe = seamless.frontend
    assert sp["frontend"]["w"].shape == (fe.embed_dim, seamless.d_model)
    assert len(sp["layers"]) == seamless.num_layers
    assert "enc_layers" not in sp
    logits = lm_apply(sp, seamless, torch.tensor([[1, 2, 3]]),
                      embeds=torch.zeros(1, fe.num_embeds, fe.embed_dim))[0]
    assert logits.shape == (1, fe.num_embeds + 3, seamless.vocab_size)
    eng = ServeEngine(seamless, sp, batch_size=2, max_len=32, device="cpu")
    assert isinstance(eng.backend, ContiguousBackend)
    from repro_torch.serve import Request

    req = Request(prompt=[1, 2, 3], max_new_tokens=3)
    eng.submit(req)
    eng.run()
    assert req.done and len(req.out) == 3
    # MLA on the contiguous ring cache (a cache without block tables)
    from repro_torch.layers.attention import (
        attention_apply,
        attention_init,
        init_kv_cache,
    )

    deepseek = reduced(get_config("deepseek-v2-lite-16b"))
    attn = attention_init(torch.Generator().manual_seed(0), deepseek)
    x = torch.randn(1, 2, deepseek.d_model,
                    generator=torch.Generator().manual_seed(1))
    ring = init_kv_cache(deepseek, 1, 8, True, torch.float32, device="cpu")
    out, got = attention_apply(attn, deepseek, x, cache=ring, mode="decode")
    assert got is ring and out.shape == x.shape
    assert ring["pos"][0].tolist() == [0, 1, -1, -1, -1, -1, -1, -1]
    want = attention_apply(attn, deepseek, x)[0]
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def test_unported_moe_options_raise():
    """An unknown MoE variant refuses, the encoder-decoder config builds
    its decoder stack through ``lm_init`` as in the reference, and a raw
    kernel has no backward of its own (the autograd Functions of
    kernels/ops.py carry the gradient; the routing-health kernel carries
    none): each refuses, never runs half."""
    from repro_torch.configs import MoEConfig, get_config, reduced
    from repro_torch.core import moe_apply, moe_init
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_online,
        routing_fwd,
        routing_health,
    )
    from repro_torch.models import lm_init

    gen = torch.Generator().manual_seed(0)
    cfg = MoEConfig(variant="soft", num_experts=4, expert_d_ff=8)
    params = moe_init(gen, 16, cfg)
    x = torch.randn(2, 5, 16)
    other = MoEConfig(variant="top_2_switch", num_experts=4, expert_d_ff=8)
    with pytest.raises(ValueError, match="unknown MoE variant"):
        moe_init(gen, 16, other)
    with pytest.raises(ValueError, match="unknown MoE variant"):
        moe_apply(params, other, x)
    for arch in ("seamless-m4t-large-v2",):
        scfg = reduced(get_config(arch))
        sp = lm_init(torch.Generator(), scfg)
        assert set(sp) == {"embed", "frontend", "layers", "final_norm",
                           "unembed"}
        assert len(sp["layers"]) == scfg.num_layers

    # A kernel wrapper handed non-CPU tensors that need a gradient refuses
    # before anything else (differentiate through kernels/ops.py instead);
    # "meta" tensors stand in for CUDA ones on a machine without a card.
    meta = dict(device="meta")
    xm = torch.empty(2, 8, 16, **meta).requires_grad_()
    phi = torch.empty(16, 4, **meta)
    ys = torch.empty(2, 4, 16, **meta)
    stats = (torch.empty(2, 8, **meta), torch.empty(2, 8, **meta))
    d_stats = (torch.empty(2, 4, **meta), torch.empty(2, 4, **meta))
    for call in (lambda: routing_fwd(xm, phi),
                 lambda: combine_apply(xm, phi, ys, stats),
                 lambda: combine_online(xm, phi, ys),
                 lambda: routing_health(xm, phi, d_stats, stats)):
        with pytest.raises(NotImplementedError, match="kernels/ops.py"):
            call()
