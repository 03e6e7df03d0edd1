"""The port's contiguous serving backend, mirroring
``tests/test_cache_pool.py`` and the JAX package's paged-vs-contiguous
parity:

- ``CachePool``: the LIFO slot cycle, a clean row at acquire (every ring
  ``pos`` -1, SSM rows zero), no other row touched by a clear, the
  ``pool_row`` / ``pool_write_row`` round trip;
- ``ServeEngine(backend="contiguous")`` is the default: a reused slot
  serves a new request exactly as a fresh engine does (llama3, and the
  SSM scrub on mamba2);
- on ``tests/test_serve_paged.py::test_paged_matches_contiguous_greedy``'s
  four archs and prompts (f32 weights and caches): the port's contiguous
  engine's greedy tokens equal the JAX contiguous engine's and the
  port's paged engine's; prompts that wrap the 16-slot rings of the
  local layers equal the JAX contiguous engine's (where, in both
  packages, the paged backend parts from the ring: see the test);
- the three contiguous programs against a no-cache forward; the
  backend's accounting, the speculative-decoding hooks (verify and the
  scrub of rejected lanes), an unknown backend's ``ValueError``, and
  ``batch_variance_probe``'s default backend;
- on the card (``cuda`` marker): the contiguous engine serves with K7
  launched 0 times.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import init_cache, lm_apply, lm_init, segment_plan
from repro_torch.optim import tree_map
from repro_torch.serve import (
    CachePool,
    ContiguousBackend,
    Request,
    ServeEngine,
    batch_variance_probe,
    make_decode_step,
    make_prefill_chunk_step,
    make_prefill_step,
    pool_row,
    pool_write_row,
)

ARCHS = ["llama3-8b", "mamba2-370m", "hymba-1.5b", "gemma3-27b"]
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [4] * 9, [5, 6] * 5, [2]]


def _cfg(get, red, name, dtype="float32"):
    return dataclasses.replace(red(get(name)), dtype=dtype)


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
        cfg = _cfg(get_config, reduced, name)
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


def _leaves(cache):
    return [t for layer in cache for v in layer.values() for t in v.values()]


def test_acquire_release_cycle():
    pool = CachePool(reduced(get_config("llama3-8b")), num_slots=3,
                     max_len=32, device="cpu")
    slots = [pool.acquire() for _ in range(3)]
    assert sorted(slots) == [0, 1, 2]
    assert pool.acquire() is None  # exhausted
    pool.release(slots[1])
    assert pool.num_free == 1
    assert pool.acquire() == slots[1]  # LIFO reuse of the hot slot
    with pytest.raises(AssertionError, match="double release"):
        pool.release(slots[0])
        pool.release(slots[0])


def test_acquired_slot_is_clean_and_other_rows_untouched():
    """A dirty row, released and acquired again, has every ring ``pos`` at
    -1 and its SSM rows zero; the clear touches no other row (hymba has
    both rings, 16 long on its local layers, and SSM rows)."""
    cfg = reduced(get_config("hymba-1.5b"))
    pool = CachePool(cfg, num_slots=3, max_len=32, device="cpu")
    assert pool.min_ring_len == 16
    for t in _leaves(pool.cache):
        t.fill_(1)
    pool._free = [1]
    slot = pool.acquire()
    assert slot == 1
    for layer in pool.cache:
        assert (layer["attn"]["pos"][slot] == -1).all()
        assert (layer["attn"]["k"][slot] == 1).all()  # stale, unreachable
        assert all((t[slot] == 0).all() for t in layer["ssm"].values())
        for t in (*layer["attn"].values(), *layer["ssm"].values()):
            assert (t[0] == 1).all() and (t[2] == 1).all()


def test_pool_row_roundtrip():
    cfg = reduced(get_config("llama3-8b"))
    pool = CachePool(cfg, num_slots=3, max_len=16, device="cpu")
    marked = CachePool(cfg, num_slots=3, max_len=16, device="cpu").cache
    for t in _leaves(marked):
        t.fill_(7)
    row = pool_row(marked, 1)
    for r, full in zip(_leaves(row), _leaves(marked)):
        assert torch.equal(r, full[1:2])
    orig = [t.clone() for t in _leaves(pool.cache)]
    assert pool_write_row(pool.cache, 1, row) is pool.cache
    for leaf, o in zip(_leaves(pool.cache), orig):
        assert (leaf[1] == 7).all()
        assert torch.equal(leaf[0], o[0]) and torch.equal(leaf[2], o[2])
    # the row view writes through to the pool
    _leaves(pool_row(pool.cache, 2))[0].fill_(3)
    assert (_leaves(pool.cache)[0][2] == 3).all()


def _serve(eng, prompts, max_new):
    reqs = [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("name,a,b", [
    ("llama3-8b", list(range(1, 30)), [9, 8, 7, 6]),
    ("mamba2-370m", list(range(20, 40)), [5, 6, 7])],
    ids=["llama3-8b", "mamba2-370m"])
def test_slot_reuse_does_not_contaminate_new_request(name, a, b):
    """Request B served in the slot request A left (batch 1), and beside a
    live neighbour in a 2-slot pool, equals B on a fresh engine: the
    stale ring rows are unreachable and the SSM rows scrubbed."""
    cfg, params = _setup(name)
    geo = dict(max_len=64, cache_dtype=torch.float32, device="cpu")
    eng = ServeEngine(cfg, params, batch_size=1, **geo)
    assert isinstance(eng.backend, ContiguousBackend)  # the default
    (ref,) = _serve(eng, [b], 5)
    assert _serve(ServeEngine(cfg, params, batch_size=1, **geo), [a, b],
                  5)[1] == ref
    eng2 = ServeEngine(cfg, params, batch_size=2, **geo)
    filler = Request(prompt=[3, 3, 3], max_new_tokens=12)
    a2 = Request(prompt=a, max_new_tokens=2)
    b2 = Request(prompt=b, max_new_tokens=5)
    for r in (filler, a2, b2):  # b2 waits for a2's slot
        eng2.submit(r)
    eng2.run()
    assert b2.out == ref


@pytest.mark.parametrize("name", ARCHS)
def test_contiguous_matches_jax_contiguous_and_paged(jx, name):
    """Greedy streams of the port's contiguous engine equal the JAX
    contiguous engine's on the same f32 weights and caches, and the port's
    paged engine's (block 8), with requests churning through 2 slots."""
    cfg, params = _setup(name)
    jcfg = _cfg(jx.get_config, jx.reduced, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                        _jax_tree(params, cfg))
    geo = dict(batch_size=2, max_len=64)
    jeng = jx.ServeEngine(jcfg, jparams, cache_dtype=jx.jnp.float32, **geo)
    jreqs = [jx.Request(prompt=list(p), max_new_tokens=5) for p in PROMPTS]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    want = [r.out for r in jreqs]
    eng = ServeEngine(cfg, params, cache_dtype=torch.float32, device="cpu",
                      **geo)
    assert _serve(eng, PROMPTS, 5) == want
    assert eng.decode_steps == jeng.decode_steps
    paged = ServeEngine(cfg, params, backend="paged", block_size=8,
                        cache_dtype=torch.float32, device="cpu", **geo)
    assert _serve(paged, PROMPTS, 5) == want


@pytest.mark.parametrize("name", ["gemma3-27b", "hymba-1.5b"])
def test_wrapping_prompts_match_jax_contiguous(jx, name):
    """Prompts of 40 and 29 tokens over the local layers' 16-slot rings,
    prefilled in chunks of 16: the port's contiguous engine equals the JAX
    contiguous engine token for token. A chunk written over a full ring
    overwrites keys that its first queries' windows still cover, so those
    queries attend fewer keys than the window: the reference's ring
    semantics. The paged pool keeps every position, so there the two
    backends part, in the reference as in the port."""
    cfg, params = _setup(name)
    jcfg = _cfg(jx.get_config, jx.reduced, name)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                        _jax_tree(params, cfg))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, n).tolist() for n in (40, 3, 29)]
    geo = dict(batch_size=2, max_len=64)
    outs = []
    for backend in ("contiguous", "paged"):
        jeng = jx.ServeEngine(jcfg, jparams, backend=backend,
                              use_kernel=False, block_size=8,
                              cache_dtype=jx.jnp.float32, **geo)
        jreqs = [jx.Request(prompt=p, max_new_tokens=8) for p in prompts]
        for r in jreqs:
            jeng.submit(r)
        jeng.run()
        eng = ServeEngine(cfg, params, backend=backend, block_size=8,
                          cache_dtype=torch.float32, device="cpu", **geo)
        got = _serve(eng, prompts, 8)
        assert got == [r.out for r in jreqs], backend
        outs.append(got)
    assert outs[0][1] == outs[1][1]  # 3 tokens: no wrap, the same stream
    assert outs[0] != outs[1]


def test_backend_accounting_and_unported_hooks():
    """Memory is slots x max_len whatever the traffic; ``max_chunk`` is the
    smallest ring; the engine's default prefill chunk fits it. The
    speculative-decoding hooks: burst reservation covers every position
    and rollback is a no-op (rows are reserved up front); ``verify``
    returns logits at every lane, equal to the no-cache forward's, and
    ``invalidate_positions`` scrubs exactly the given lanes of one row.
    An unknown backend is a ``ValueError``, as in the reference."""
    cfg, params = _setup("gemma3-27b")  # window 16: every ring is 16 long
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64, device="cpu",
                      cache_dtype=torch.float32)
    be = eng.backend
    assert be.max_chunk == 16 and eng.sched.prefill_chunk == 16
    assert be.token_capacity() == 128 and be.tokens_free() == 128
    assert be.occupancy() == {"slots_free": 2, "slots_total": 2}
    a = cfg.attention
    per_layer = 2 * 16 * (2 * a.num_kv_heads * a.head_dim * 4 + 4)
    assert be.peak_cache_bytes() == cfg.num_layers * per_layer
    assert be.accepts(60, 4) and not be.accepts(61, 4)
    r = Request(prompt=[1, 2, 3], max_new_tokens=2)
    eng.submit(r)
    eng._admit()
    assert be.tokens_free() == 64 and be.occupancy()["slots_free"] == 1
    eng.run()
    assert be.tokens_free() == 128
    assert be.reserve_burst(0, 5, 4) == 4
    assert be.rollback_burst(0, 6) is None
    toks = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
    pos = torch.tensor([[0, 1, 2, 3, 4], [0, 1, 2, -1, -1]],
                       dtype=torch.int32)
    be.try_admit(None)
    be.try_admit(None)
    logits = be.verify(params, toks, pos)
    assert logits.shape == (2, 5, cfg.vocab_size)
    want = lm_apply(params, cfg, toks)[0]
    np.testing.assert_allclose(logits[0].numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits[1, :3].numpy(), want[1, :3].numpy(),
                               rtol=1e-5, atol=1e-5)
    be.invalidate_positions(torch.tensor([[3, 4, -1], [-1, -1, -1]],
                                         dtype=torch.int32))
    for layer in be.pool.cache:
        ring = layer["attn"]["pos"]
        assert ring[0, :5].tolist() == [0, 1, 2, -1, -1]
        assert ring[1, :3].tolist() == [0, 1, 2] and (ring[1, 3:] == -1).all()
    with pytest.raises(ValueError, match="unknown backend"):
        ServeEngine(cfg, params, batch_size=2, max_len=64, device="cpu",
                    backend="ring")


def test_programs_match_the_forward():
    """The contiguous programs on ``init_cache``: the whole-prompt
    prefill's last logits equal a no-cache forward's; a decode step after
    it equals the forward one position on, an inactive row (position -1)
    leaving its ring as it was; a chunk prefilled into slot 1 through its
    row view writes that row only."""
    cfg, params = _setup("gemma3-27b")
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(1, 256, (2, 13)))
    want = lm_apply(params, cfg, toks)[0]
    cache = init_cache(cfg, 2, 32, torch.float32, device="cpu")
    got = make_prefill_step(cfg, 32)(params, toks[:, :12], cache)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 11].numpy(),
                               rtol=1e-5, atol=1e-5)
    before = [layer["attn"]["pos"][1].clone() for layer in cache]
    step = make_decode_step(cfg)(params, toks[:, 12:], torch.tensor(
        [12, -1], dtype=torch.int32), cache)
    np.testing.assert_allclose(step[0, 0].numpy(), want[0, 12].numpy(),
                               rtol=1e-5, atol=1e-5)
    for layer, old in zip(cache, before):
        assert torch.equal(layer["attn"]["pos"][1], old)
    pool = init_cache(cfg, 2, 32, torch.float32, device="cpu")
    buf = torch.zeros(2, cfg.vocab_size)
    out = make_prefill_chunk_step(cfg)(
        params, pool, buf, 1, toks[:1, :12],
        torch.arange(12, dtype=torch.int32)[None])
    assert out is buf and not buf[0].any()
    np.testing.assert_allclose(buf[1].numpy(), want[0, 11].numpy(),
                               rtol=1e-5, atol=1e-5)
    for layer in pool:
        assert (layer["attn"]["pos"][0] == -1).all()
        assert (layer["attn"]["pos"][1] >= 0).sum() == 12


def test_probe_defaults_to_the_contiguous_backend():
    """``batch_variance_probe`` serves on the contiguous backend unless
    told otherwise, as in the reference, and reads below 1e-5 there on a
    served (bf16) dense config, as on the paged one."""
    sig = inspect.signature(batch_variance_probe)
    assert sig.parameters["backend"].default == "contiguous"
    assert inspect.signature(ServeEngine).parameters[
        "backend"].default == "contiguous"
    cfg, params = _setup("llama3-8b")
    served = dataclasses.replace(cfg, dtype="bfloat16")
    for kw in ({}, {"backend": "paged"}):
        res = batch_variance_probe(served, params, [1, 2, 3, 4],
                                   batch_size=4, max_new_tokens=6,
                                   max_len=32, device="cpu", **kw)
        assert res["steps_compared"] > 0
        assert res["divergence"] < 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama3-8b", "hymba-1.5b"])
def test_contiguous_engine_on_the_card(card, name):
    """On the card the contiguous engine serves with no kernel (K7 never
    launches: attention gathers the ring, as in the reference), and its
    greedy tokens equal the paged gather engine's in f32."""
    from repro_torch.kernels.paged_attention import paged_decode_attend

    cfg = _cfg(get_config, reduced, name)
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    geo = dict(batch_size=2, max_len=64, cache_dtype=torch.float32)
    paged_decode_attend.launches = 0
    out = _serve(ServeEngine(cfg, params, **geo), PROMPTS, 8)
    assert paged_decode_attend.launches == 0
    ref = _serve(ServeEngine(cfg, params, backend="paged", use_kernel=False,
                             **geo), PROMPTS, 8)
    assert out == ref
