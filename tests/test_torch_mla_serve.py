"""Serving the MLA and vlm models in the port, on the paged backend:

- reduced ``deepseek-v2-lite-16b`` (MLA, Tokens Choice) and reduced
  ``pixtral-12b`` (GQA; text only, as the serving programs take no
  embeds) against the JAX paged engine (gather path) on the same f32
  weights: greedy tokens equal, with a radix prefix hit and preemptions
  in both;
- MLA decode never runs the paged decode-attention kernel (the
  reference's design), while pixtral's decode runs it once a layer a
  step; telemetry on serves the same tokens as off, dropless;
- prefix-cache hits on MLA's latent pool leave the tokens unchanged;
- ``batch_variance_probe`` reads below 1e-5 on reduced deepseek, the
  contract of the JAX package's ``tests/test_batch_invariance.py``;
- on the card (``cuda`` marker): both reduced archs served, K7 launches
  0 for deepseek and decode steps x layers for pixtral.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.layers import attention as tattn
from repro_torch.models import lm_init, segment_plan
from repro_torch.optim import tree_map
from repro_torch.serve import Request, ServeEngine, batch_variance_probe

ARCHS = ["deepseek-v2-lite-16b", "pixtral-12b"]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jget_config, reduced=jreduced,
        Request=JRequest, ServeEngine=JServeEngine)


def _jax_tree(params, cfg):
    """The port's params in the JAX package's layout: each segment's
    layers stacked on a leading axis."""
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][start:start + count])
        for start, count, _ in segment_plan(cfg)]
    return tree


def _prompts():
    """Mixed lengths (29, 33, 3, 40, 17 tokens); prompts 0 and 1 share a
    24-token prefix."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 256, 24).tolist()
    p0 = shared + rng.randint(1, 256, 5).tolist()
    short, long_, mid = (rng.randint(1, 256, n).tolist() for n in (3, 40, 17))
    return [p0, shared + rng.randint(1, 256, 9).tolist(), short, long_, mid]


def _serve(cfg, params, prompts, max_new=6, **kw):
    geo = dict(batch_size=2, max_len=64, block_size=8, device="cpu",
               backend="paged")
    geo.update(kw)
    eng = ServeEngine(cfg, params, **geo)
    reqs = [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return eng, [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax_engine(jx, arch):
    """Greedy streams equal the JAX paged engine's token for token, with
    the same schedule (7 usable blocks of 8 tokens: prompt 1 waits for
    prompt 0 to publish the shared prefix, and rows are preempted)."""
    jcfg = dataclasses.replace(jx.reduced(jx.get_config(arch)),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                        _jax_tree(params, cfg))
    geo = dict(batch_size=2, max_len=64, block_size=8, num_blocks=8)
    jeng = jx.ServeEngine(jcfg, jparams, backend="paged", use_kernel=False,
                          cache_dtype=jx.jnp.float32, **geo)
    teng = ServeEngine(cfg, params, cache_dtype=torch.float32, device="cpu",
                       backend="paged", **geo)
    outs = []
    for eng, req in ((jeng, jx.Request), (teng, Request)):
        reqs = [req(prompt=p, max_new_tokens=10) for p in _prompts()]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.finish_reason == "length" for r in reqs)
        assert eng.backend.prefix.hits >= 1 and eng.preemptions >= 1
        outs.append(([r.out for r in reqs], eng.decode_steps,
                     eng.preemptions))
    assert outs[1] == outs[0]


_PARAMS = {}


def _setup(arch):
    """Reduced config (bf16 compute, as served) and seeded params."""
    if arch not in _PARAMS:
        cfg = reduced(get_config(arch))
        _PARAMS[arch] = (cfg, lm_init(torch.Generator().manual_seed(1), cfg))
    return _PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_kernel_calls_and_telemetry_parity(arch, monkeypatch):
    """With ``use_kernel=True`` (the default) MLA decode gathers and never
    calls the paged decode-attention kernel's wrapper; pixtral calls it
    once a layer a decode step. Telemetry on serves the same tokens, and
    deepseek's Tokens Choice layers route dropless."""
    cfg, params = _setup(arch)
    calls = []
    inner = tattn.paged_decode_attend
    monkeypatch.setattr(tattn, "paged_decode_attend",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    eng, off = _serve(cfg, params, prompts)
    want = 0 if cfg.attention.kind == "mla" else \
        eng.decode_steps * cfg.num_layers
    assert eng.decode_steps > 0 and len(calls) == want
    eng, on = _serve(cfg, params, prompts, telemetry=True)
    assert on == off
    flat = eng.telemetry_snapshot()["decode"]
    assert all(np.isfinite(v) for v in flat.values())
    for i in cfg.moe_layer_indices():
        assert flat[f"moe_l{i}_dropped_fraction"] == 0.0


def test_prefix_cache_parity_on_the_latent_pool():
    """Radix prefix hits on MLA's ``ckv``/``krope`` pools (three prompts
    sharing 14 tokens, blocks of 4) leave the tokens as they are without
    the prefix cache. The copy-on-write fork of the latent pool is held
    to JAX in ``tests/test_torch_mla.py``."""
    cfg, params = _setup(ARCHS[0])
    prompts = [[7] * 14 + [i + 1] for i in range(3)]
    _, cold = _serve(cfg, params, prompts, block_size=4, prefix_cache=False)
    eng, warm = _serve(cfg, params, prompts, block_size=4, prefix_cache=True)
    assert warm == cold
    assert eng.backend.prefix.hits > 0


def test_batch_variance_probe_null_on_deepseek():
    cfg, params = _setup(ARCHS[0])
    res = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=4,
                               max_new_tokens=8, max_len=32, device="cpu",
                               backend="paged")
    assert res["steps_compared"] > 0
    assert any(":router_entropy" in k for k in res["per_stat"])
    assert res["divergence"] < 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_on_the_card(card, arch):
    """On the card: the engine serves reduced deepseek (K7 never runs: MLA
    gathers) and reduced pixtral (K7 once a layer a decode step), with
    the same tokens with telemetry on and off."""
    from repro_torch.kernels.paged_attention import paged_decode_attend

    cfg = reduced(get_config(arch))
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    outs = []
    for telemetry in (False, True):
        eng = ServeEngine(cfg, params, batch_size=4, max_len=64,
                          block_size=8, telemetry=telemetry,
                          backend="paged")
        reqs = [Request(prompt=list(p), max_new_tokens=8)
                for p in ([1, 2, 3, 4, 5], [9, 8, 7], [4] * 6, [2, 4, 6])]
        paged_decode_attend.launches = 0
        for r in reqs:
            eng.submit(r)
        eng.run()
        want = 0 if cfg.attention.kind == "mla" else \
            eng.decode_steps * cfg.num_layers
        assert eng.decode_steps > 0
        assert paged_decode_attend.launches == want
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
