"""Serving the SSM and hybrid LMs in the port, on the paged backend:

- reduced ``mamba2-370m`` and reduced ``hymba-1.5b`` (``global_every=2``:
  window-16 and global layers) against the JAX paged engine (gather path)
  on the same f32 weights: greedy tokens equal, prompts longer than the
  window prefilled in chunks of 8, more requests than slots, and
  preemptions; the prefix cache is off for both even when asked for;
- the chunked prefill's last logits equal a whole-prompt ``lm_apply``
  within 1e-5, and a slot's SSM rows are zeroed at admission;
- telemetry on serves the same tokens as off; ``batch_variance_probe``
  reads below 1e-5 on the served (bf16) config; ``peak_cache_bytes``
  counts the SSM rows;
- ``serving_params`` keeps ``A_log``, ``D`` and ``dt_bias`` in f32, and
  the served forward equals one on the f32 params cast at each use;
- on the card (``cuda`` marker): K7 launches 0 for mamba2 and decode
  steps x layers for hymba.

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
from repro_torch.models import lm_apply, lm_init, segment_plan
from repro_torch.optim import tree_map
from repro_torch.serve import Request, ServeEngine, batch_variance_probe
from repro_torch.serve.engine import serving_params

ARCHS = ["mamba2-370m", "hymba-1.5b"]


def _reduced(get, red, name, dtype="float32"):
    cfg = dataclasses.replace(red(get(name)), dtype=dtype)
    if cfg.attention is not None:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, global_every=2))
    return cfg


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


_PARAMS = {}


def _setup(name):
    """Reduced f32 config and seeded params, made once a module."""
    if name not in _PARAMS:
        cfg = _reduced(get_config, reduced, name)
        _PARAMS[name] = (cfg, lm_init(torch.Generator().manual_seed(
            ARCHS.index(name)), cfg))
    return _PARAMS[name]


def _jax_tree(params, cfg):
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][start:start + count])
        for start, count, _ in segment_plan(cfg)]
    return tree


def _prompts():
    """Five prompts of 29, 33, 3, 40 and 17 tokens (four longer than the
    reduced window of 16)."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, n).tolist() for n in (29, 33, 3, 40, 17)]


GEO = dict(batch_size=2, max_len=64, block_size=8, num_blocks=8,
           prefill_chunk=8)


@pytest.mark.parametrize("name", ARCHS)
def test_engine_tokens_match_jax_engine(jx, name):
    """Greedy streams equal the JAX paged engine's token for token, with
    the same schedule (7 usable blocks of 8 tokens for 5 requests on 2
    slots: rows are preempted and restart from a cleared slot)."""
    cfg, params = _setup(name)
    jcfg = _reduced(jx.get_config, jx.reduced, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                        _jax_tree(params, cfg))
    jeng = jx.ServeEngine(jcfg, jparams, backend="paged", use_kernel=False,
                          cache_dtype=jx.jnp.float32, **GEO)
    teng = ServeEngine(cfg, params, cache_dtype=torch.float32, device="cpu",
                       backend="paged", **GEO)
    outs = []
    for eng, req in ((jeng, jx.Request), (teng, Request)):
        assert eng.backend.prefix is None
        reqs = [req(prompt=p, max_new_tokens=10) for p in _prompts()]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.finish_reason == "length" for r in reqs)
        assert eng.preemptions >= 1
        outs.append(([r.out for r in reqs], eng.decode_steps,
                     eng.preemptions))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("name", ARCHS)
def test_chunked_prefill_equals_whole_prompt_forward(name):
    """A 29-token prompt prefilled in chunks of 8 (left pad 3) into a slot
    of a backend whose SSM rows hold stale state: the slot is zeroed at
    admission, its last logits equal one whole-prompt ``lm_apply`` within
    1e-5, the other slot's SSM rows are untouched, and the prefix cache
    stays off though asked for."""
    cfg, params = _setup(name)
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64, block_size=8,
                      prefill_chunk=8, prefix_cache=True,
                      cache_dtype=torch.float32, device="cpu",
                      backend="paged")
    be = eng.backend
    assert be.prefix is None
    for layer in be.cache:
        for t in layer["ssm"].values():
            t.normal_(generator=torch.Generator().manual_seed(5))
    before = [{k: t.clone() for k, t in layer["ssm"].items()}
              for layer in be.cache]
    prompt = _prompts()[0]
    req = Request(prompt=prompt, max_new_tokens=4)
    eng.submit(req)
    eng._admit()
    entry = eng.sched.entry_for(req)
    slot, other = entry.slot, 1 - entry.slot
    assert entry.left_pad == 3
    for layer in be.cache:
        assert all((t[slot] == 0).all() for t in layer["ssm"].values())
    while not entry.prefill_done():
        eng._do_prefill_chunk()
    with torch.no_grad():
        want = lm_apply(params, cfg, torch.tensor([prompt]))[0][0, -1]
    np.testing.assert_allclose(eng._logits[slot].numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    for layer, old in zip(be.cache, before):
        for k, t in layer["ssm"].items():
            assert torch.equal(t[other], old[k][other]), k
            assert not torch.equal(t[slot], old[k][slot]), k


@pytest.mark.parametrize("name", ARCHS)
def test_telemetry_parity_probe_and_cache_bytes(name):
    cfg, params = _setup(name)
    geo = dict(batch_size=2, max_len=64, block_size=8, device="cpu",
               backend="paged")
    outs, engs = [], []
    for telemetry in (False, True):
        eng = ServeEngine(cfg, params, telemetry=telemetry, **geo)
        reqs = [Request(prompt=p, max_new_tokens=6) for p in _prompts()[:3]]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
        engs.append(eng)
    assert outs[0] == outs[1]
    flat = engs[1].telemetry_snapshot()["decode"]
    assert all(np.isfinite(v) for v in flat.values())
    assert ("l0_max_attn_out" in flat) == cfg.has_attention()
    be = engs[0].backend
    ssm = sum(t.numel() * t.element_size() for layer in be.cache
              for t in layer["ssm"].values())
    assert be.ssm_bytes() == ssm > 0
    assert be.peak_cache_bytes() == \
        be.live_block_hw * be.bytes_per_block() + ssm
    assert (be.bytes_per_block() > 0) == cfg.has_attention()
    # the probe on the served config (bf16 compute); in f32 on the CPU
    # the reference's own probe reads up to ~1e-4 on these archs (f32
    # GEMM rounding by row count, scaled by the logits)
    served = dataclasses.replace(cfg, dtype="bfloat16")
    res = batch_variance_probe(served, params, [1, 2, 3, 4], batch_size=4,
                               max_new_tokens=8, max_len=32, device="cpu",
                               backend="paged")
    assert res["steps_compared"] > 0
    assert res["divergence"] < 1e-5


def test_serving_params_keep_ssm_f32_leaves():
    """With bf16 compute the SSM's ``A_log``, ``D`` and ``dt_bias`` stay
    in their stored f32 and every other SSM weight is cast once to bf16;
    the served forward equals the forward on the f32 params (the layers
    cast at each use) bitwise, and casting the kept leaves to bf16 would
    move it. The engine's prefill of one whole chunk gives the forward's
    last logits (within 1e-5: its unembed is a one-row product)."""
    cfg = reduced(get_config("mamba2-370m"))
    assert cfg.dtype == "bfloat16"
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    sp = serving_params(params, cfg)
    kept = ("A_log", "D", "dt_bias")
    for layer, src in zip(sp["layers"], params["layers"]):
        for k, t in layer["ssm"].items():
            if k in kept:
                assert t.dtype == torch.float32 and t is src["ssm"][k], k
            else:
                assert t.dtype == torch.bfloat16, k
    tokens = torch.tensor([_prompts()[0]])
    with torch.no_grad():
        served = lm_apply(sp, cfg, tokens)[0]
        want = lm_apply(params, cfg, tokens)[0]
        lossy = [dict(layer, ssm={k: v.to(torch.bfloat16)
                                  for k, v in layer["ssm"].items()})
                 for layer in sp["layers"]]
        moved = lm_apply(dict(sp, layers=lossy), cfg, tokens)[0]
    assert torch.equal(served, want)
    assert not torch.equal(moved, want)
    eng = ServeEngine(cfg, params, batch_size=1, max_len=64, block_size=8,
                      prefill_chunk=32, device="cpu", backend="paged")
    assert eng.params["layers"][0]["ssm"]["A_log"].dtype == torch.float32
    prompt = _prompts()[3][:32]
    eng.submit(Request(prompt=prompt, max_new_tokens=1))
    eng._admit()
    eng._do_prefill_chunk()
    with torch.no_grad():
        want = lm_apply(params, cfg, torch.tensor([prompt]))[0][0, -1]
    np.testing.assert_allclose(eng._logits[0].numpy(), want.float().numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_paged_kernel_calls(name, monkeypatch):
    """With ``use_kernel=True`` (the default) mamba2's decode calls the
    paged decode-attention kernel's wrapper never, hymba's once a layer a
    decode step."""
    cfg, params = _setup(name)
    calls = []
    inner = tattn.paged_decode_attend
    monkeypatch.setattr(tattn, "paged_decode_attend",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64, block_size=8,
                      device="cpu", backend="paged")
    for p in ([1, 2, 3, 4], [9, 8, 7]):
        eng.submit(Request(prompt=p, max_new_tokens=5))
    eng.run()
    want = eng.decode_steps * cfg.num_layers if cfg.has_attention() else 0
    assert eng.decode_steps > 0 and len(calls) == want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_engine_serves_on_the_card(card, name):
    """On the card: the engine serves reduced mamba2 (K7 never runs: no
    attention) and reduced hymba (K7 once a layer a decode step)."""
    from repro_torch.kernels.paged_attention import paged_decode_attend

    cfg = reduced(get_config(name))
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=4, max_len=64, block_size=8,
                      backend="paged")
    reqs = [Request(prompt=list(p), max_new_tokens=8)
            for p in ([1, 2, 3, 4, 5], [9, 8, 7], [4] * 20, [2, 4, 6])]
    paged_decode_attend.launches = 0
    for r in reqs:
        eng.submit(r)
    eng.run()
    want = eng.decode_steps * cfg.num_layers if cfg.has_attention() else 0
    assert eng.decode_steps > 0 and all(r.done for r in reqs)
    assert paged_decode_attend.launches == want
