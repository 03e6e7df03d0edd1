"""Serving MoE LMs in the port: the cases of the JAX package's
``tests/test_batch_invariance.py`` and the probe cases of
``tests/test_telemetry.py``, on the paged backend (the port's one), for
reduced ``granite-moe-1b-a400m`` (sparse Tokens Choice) and
``granite-moe-1b-a400m+soft`` (deepseek-v2-lite, an MLA model, is served
in ``tests/test_torch_mla_serve.py``).

- Against the JAX paged engine (gather path) on the same converted f32
  weights: greedy tokens equal, and ``telemetry_snapshot()`` within 1e-4
  (atol and rtol) of the JAX engine's.
- Inside the port: a request's tokens alone equal its tokens co-batched,
  greedy and sampled, under group/capacity/BPR knobs that bind in train
  mode; chunked prefill equals the whole-prompt forward on the sparse
  arch; the prefill chunk size is invisible under binding capacity;
  prefix-cache hits leave the tokens unchanged; telemetry on and off
  give the same tokens; the ``batch_coupled`` hatch makes co-batched
  differ from solo (so the equalities are not vacuous).
- ``batch_variance_probe`` reads < 1e-5 on grouped BPR Tokens Choice
  with binding capacity, on Soft MoE and on a dense arch, and > 0
  through the hatch.
- ``serving_params`` keeps the routing weights in f32.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import lm_apply, lm_init
from repro_torch.serve import (
    Request,
    SamplingParams,
    ServeEngine,
    batch_variance_probe,
)
from repro_torch.serve.engine import serving_params

MOE_ARCHS = ["granite-moe-1b-a400m", "granite-moe-1b-a400m+soft"]
WORST = dict(group_size=4, capacity_factor=0.5, bpr=True)
HATCH = dict(WORST, batch_coupled=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import lm_init as jlm_init
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jget_config, reduced=jreduced,
        lm_init=jlm_init, Request=JRequest, ServeEngine=JServeEngine)


_PARAMS = {}


def _setup(jx, name, **moe_over):
    """Reduced config (MoE knobs overridden) and the JAX package's
    ``lm_init(PRNGKey(0))`` params converted to the port, as the
    reference tests draw them; cached per module."""
    key = (name, tuple(sorted(moe_over.items())))
    if key not in _PARAMS:
        cfg = reduced(get_config(name))
        if moe_over:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
        jcfg = jx.reduced(jx.get_config(name))
        jcfg = dataclasses.replace(jcfg, moe=cfg.moe)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        tree = jx.jax.tree_util.tree_map(
            np.asarray, jx.lm_init(jx.jax.random.PRNGKey(0), jcfg))
        _PARAMS[key] = (cfg, params_from_jax(tree, cfg, device="cpu"))
    return _PARAMS[key]


def _serve(cfg, params, prompts, sampling=None, max_new=8, **kw):
    """Serve ``prompts`` on the CPU; returns (engine, token lists)."""
    geo = dict(batch_size=max(1, len(prompts)), max_len=64, block_size=8,
               backend="paged")
    geo.update(kw)
    eng = ServeEngine(cfg, params, device="cpu", **geo)
    reqs = [Request(prompt=list(p), max_new_tokens=max_new,
                    sampling=sampling or SamplingParams()) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return eng, [r.out for r in reqs]


PROMPT = [1, 2, 3, 4, 5]
FILLERS = [[9, 8, 7], [4] * 6, [2, 4, 6, 8]]
SAMPLED = SamplingParams(temperature=0.9, top_k=20, seed=7)


# -- against the JAX engine ---------------------------------------------------


def _prompts():
    """Mixed lengths (29, 33, 3, 40, 17 tokens); prompts 0 and 1 share a
    24-token prefix."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 256, 24).tolist()
    p0 = shared + rng.randint(1, 256, 5).tolist()
    short, long_, mid = (rng.randint(1, 256, n).tolist() for n in (3, 40, 17))
    return [p0, shared + rng.randint(1, 256, 9).tolist(), short, long_, mid]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_and_telemetry_match_jax_engine(jx, arch):
    """Greedy streams equal the JAX paged engine's token for token (with
    a radix prefix hit and preemptions in both: 7 usable blocks of 8
    tokens, so prompt 1 waits for prompt 0 to publish the shared prefix),
    and the latest telemetry per phase agrees within 1e-4: the same
    routes, the same routing health."""
    jcfg = dataclasses.replace(jx.reduced(jx.get_config(arch)),
                               dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jx.lm_init(jx.jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jx.jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    geo = dict(batch_size=2, max_len=64, block_size=8, num_blocks=8,
               telemetry=True)
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
    want, got = jeng.telemetry_snapshot(), teng.telemetry_snapshot()
    assert set(got) == set(want) == {"prefill", "decode"}
    for phase in want:
        assert set(got[phase]) == set(want[phase]), phase
        assert any(k.startswith("moe_") for k in got[phase])
        for k, v in want[phase].items():
            np.testing.assert_allclose(got[phase][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{phase} {k}")


# -- batch invariance inside the port ----------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_solo_equals_cobatched(jx, arch, sampled):
    """A request's tokens are a function of the request, never of its
    batch neighbours, with the knobs that couple rows in train mode."""
    cfg, params = _setup(jx, arch, **WORST)
    sp = SAMPLED if sampled else None
    _, (solo,) = _serve(cfg, params, [PROMPT], sp)
    _, cob = _serve(cfg, params, [PROMPT] + FILLERS, sp)
    assert solo == cob[0]


def test_escape_hatch_restores_batch_coupling_end_to_end(jx):
    """``batch_coupled=True`` routes served rows in coupled groups again:
    the same knobs now make the co-batched stream differ from the solo
    one, so the equality above is not vacuous."""
    cfg, params = _setup(jx, "granite-moe-1b-a400m", **HATCH)
    _, (solo,) = _serve(cfg, params, [PROMPT])
    _, cob = _serve(cfg, params, [PROMPT] + FILLERS)
    assert solo != cob[0]


def test_chunked_prefill_matches_whole_prompt_forward_sparse(jx):
    """With capacity slack the train-mode forward routes as serving's
    dropless per-row path, so the whole-prompt ``lm_apply`` is the
    oracle of chunked prefill (10 tokens in chunks of 4)."""
    cfg, params = _setup(jx, "granite-moe-1b-a400m", capacity_factor=8.0)
    prompt = list(range(1, 11))
    cur = torch.tensor([prompt])
    ref = []
    with torch.no_grad():
        for _ in range(5):
            logits, _, _ = lm_apply(params, cfg, cur, mode="train")
            nxt = int(torch.argmax(logits[0, -1]))
            ref.append(nxt)
            cur = torch.cat([cur, torch.tensor([[nxt]])], 1)
    _, (out,) = _serve(cfg, params, [prompt], max_new=5, batch_size=2,
                       prefill_chunk=4)
    assert out == ref


def test_chunk_size_invisible_under_binding_capacity(jx):
    cfg, params = _setup(jx, "granite-moe-1b-a400m", group_size=4,
                         capacity_factor=0.25, bpr=True)
    prompt = list(range(3, 17))
    outs = [_serve(cfg, params, [prompt], max_new=6, batch_size=2,
                   prefill_chunk=chunk)[1][0] for chunk in (None, 4, 7)]
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefix_cache_parity_on_moe(jx, arch):
    cfg, params = _setup(jx, arch)
    prompts = [[7] * 12 + [i + 1] for i in range(3)]
    _, cold = _serve(cfg, params, prompts, max_new=6, batch_size=2,
                     block_size=4, prefix_cache=False)
    eng, warm = _serve(cfg, params, prompts, max_new=6, batch_size=2,
                       block_size=4, prefix_cache=True)
    assert warm == cold
    assert eng.backend.prefix.hits > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_telemetry_token_parity(jx, arch, sampled):
    """Telemetry on serves the same tokens as off; its stats populate
    both phases, finite, with each MoE layer's routing keys and, on the
    sparse arch, a dropless ``dropped_fraction`` of exactly 0."""
    cfg, params = _setup(jx, arch)
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    sp = SAMPLED if sampled else None
    _, off = _serve(cfg, params, prompts, sp, max_new=6)
    eng, on = _serve(cfg, params, prompts, sp, max_new=6, telemetry=True)
    assert on == off
    snap = eng.telemetry_snapshot()
    assert set(snap) == {"prefill", "decode"}
    for flat in snap.values():
        assert all(np.isfinite(v) for v in flat.values())
        for i in cfg.moe_layer_indices():
            key = ("router_entropy" if cfg.moe.variant == "tokens_choice"
                   else "dispatch_entropy")
            assert f"moe_l{i}_{key}" in flat
            if cfg.moe.variant == "tokens_choice":
                assert flat[f"moe_l{i}_dropped_fraction"] == 0.0
    gauges = eng.telemetry.gauges()
    assert any(k.startswith("moe_decode_l") for k in gauges)
    assert any(k.startswith("model_prefill_logits") for k in gauges)


# -- the batch-variance probe ------------------------------------------------


def test_batch_variance_probe_null_on_group_routed_sparse_and_dense(jx):
    cfg, params = _setup(jx, "granite-moe-1b-a400m", **WORST)
    grouped = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=4,
                                   max_new_tokens=8, max_len=32,
                                   device="cpu", backend="paged")
    assert grouped["steps_compared"] > 0
    assert any(":router_entropy" in k for k in grouped["per_stat"])
    assert grouped["divergence"] < 1e-5
    dcfg, dparams = _setup(jx, "llama3-8b")
    dense = batch_variance_probe(dcfg, dparams, [1, 2, 3, 4], batch_size=4,
                                 max_new_tokens=8, max_len=32, device="cpu",
                                 backend="paged")
    assert dense["steps_compared"] > 0
    assert dense["divergence"] < 1e-5


def test_batch_variance_probe_null_on_soft_moe(jx):
    cfg, params = _setup(jx, "granite-moe-1b-a400m+soft")
    res = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=3,
                               max_new_tokens=6, max_len=32, device="cpu",
                               backend="paged")
    assert res["steps_compared"] > 0
    assert any(":dispatch_entropy" in k for k in res["per_stat"])
    assert res["divergence"] < 1e-5


def test_batch_variance_probe_instrument_alive_via_escape_hatch(jx):
    cfg, params = _setup(jx, "granite-moe-1b-a400m", **HATCH)
    res = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=4,
                               max_new_tokens=8, max_len=32, device="cpu",
                               backend="paged")
    assert res["steps_compared"] > 0
    assert res["divergence"] > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_params_keep_routing_weights_in_f32(jx, arch):
    """The router (sparse) and phi and scale (Soft MoE) stay f32, as the
    reference serves them; every other layer weight is cast once to the
    compute dtype, and the embedding stays f32."""
    cfg, params = _setup(jx, arch)
    assert cfg.dtype == "bfloat16"
    sp = serving_params(params, cfg)
    for i in cfg.moe_layer_indices():
        moe = sp["layers"][i]["moe"]
        routing = {"router"} if "router" in moe else {"phi", "scale"}
        for k in routing:
            assert moe[k].dtype == torch.float32, k
            assert torch.equal(moe[k], params["layers"][i]["moe"][k])
        for w in moe["experts"].values():
            assert w.dtype == torch.bfloat16
        assert sp["layers"][i]["attn"]["wq"].dtype == torch.bfloat16
    assert sp["embed"]["table"].dtype == torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_serves_moe_on_the_card_with_telemetry_and_k7(card, arch):
    """On the card: the engine serves a reduced MoE LM with telemetry on
    through the paged decode-attention kernel (K7, one launch a layer a
    decode step), with the same tokens as telemetry off, every routing
    stat finite and a dropless sparse route."""
    from repro_torch.kernels.paged_attention import paged_decode_attend

    cfg = reduced(get_config(arch))
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    outs = []
    for telemetry in (False, True):
        eng = ServeEngine(cfg, params, batch_size=4, max_len=64,
                          block_size=8, telemetry=telemetry,
                          backend="paged")
        reqs = [Request(prompt=list(p), max_new_tokens=8)
                for p in [PROMPT] + FILLERS]
        paged_decode_attend.launches = 0
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert paged_decode_attend.launches == (eng.decode_steps
                                                * cfg.num_layers) > 0
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    snap = eng.telemetry_snapshot()["decode"]
    assert all(np.isfinite(v) for v in snap.values())
    if cfg.moe.variant == "tokens_choice":
        for i in cfg.moe_layer_indices():
            assert snap[f"moe_l{i}_dropped_fraction"] == 0.0
