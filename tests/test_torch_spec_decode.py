"""Speculative decoding, ``cache_generated`` and ``fork_slot`` in the
port, held against the JAX package (the counterparts of
``tests/test_spec_decode.py``):

- ``NgramDrafter`` proposals equal JAX's on seeded contexts;
- ``spec_accept_tokens``: greedy acceptance counts and chains equal
  JAX's on the same logits; a sampled lane j is bitwise the port's own
  ``sample_tokens`` at step + j (the port's keys are ``_row_seed``, not
  JAX's ``fold_in``: a known, intended difference);
- greedy speculative tokens equal the JAX speculative engine's and the
  port's plain engine's (reduced qwen2-0.5b on both backends, reduced
  granite-moe-1b-a400m on the paged one; f32 weights and caches);
- sampled speculative streams equal the port's plain streams token for
  token;
- rollback: every tick leaves the row's blocks, refcounts and pos pool
  in the never-drafted state, and after a run with every draft rejected
  the tables, refcounts, free list and pos pools equal a never-drafted
  engine's bitwise, K/V at live positions within 1e-5 (f32 rounding of a
  (B, k+1) verify against (B, 1) decode steps; dense and MoE;
  the reference's own MoE rollback test is red, so this is held within
  the port);
- EOS inside a burst, every finish reason, preemption under pressure;
- the refusals, with the reference's ``ValueError`` messages;
- ``cache_generated``: prefix hits past the first prompt, hit counts
  equal to the JAX paged engine's, off by default;
- ``fork_slot``: copy-on-write of refcounts and tokens.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import lm_init, segment_plan
from repro_torch.optim import tree_map
from repro_torch.serve import (
    ContiguousBackend,
    NgramDrafter,
    Request,
    SamplingParams,
    ServeEngine,
    SpecConfig,
    SpecDecoder,
    sample_tokens,
    spec_accept_tokens,
)

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [4] * 9]
PAGED = dict(backend="paged", block_size=8)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.serve import NgramDrafter as JNgramDrafter
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve import SpecConfig as JSpecConfig
    from repro.serve import SpecDecoder as JSpecDecoder
    from repro.serve import spec_accept_tokens as jaccept
    from repro.serve.cache_pool import ContiguousBackend as JContiguous

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jget_config, reduced=jreduced,
        NgramDrafter=JNgramDrafter, Request=JRequest,
        ServeEngine=JServeEngine, SpecConfig=JSpecConfig,
        SpecDecoder=JSpecDecoder, accept=jax.jit(jaccept),
        Contiguous=JContiguous)


_PARAMS = {}


def _setup(name):
    """Reduced f32 config and seeded params, made once a module."""
    if name not in _PARAMS:
        cfg = dataclasses.replace(reduced(get_config(name)), dtype="float32")
        _PARAMS[name] = (cfg, lm_init(torch.Generator().manual_seed(0), cfg))
    return _PARAMS[name]


def _jax_setup(jx, name):
    cfg, params = _setup(name)
    jcfg = dataclasses.replace(jx.reduced(jx.get_config(name)),
                               dtype="float32")
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][start:start + count])
        for start, count, _ in segment_plan(cfg)]
    return jcfg, jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)


def _engine(name, spec=None, batch=2, max_len=64, **kw):
    cfg, params = _setup(name)
    return ServeEngine(cfg, params, batch_size=batch, max_len=max_len,
                       spec=spec, cache_dtype=torch.float32, device="cpu",
                       **kw)


def _serve(eng, prompts=PROMPTS, max_new=12, sampling=None):
    reqs = [Request(prompt=list(p), max_new_tokens=max_new,
                    sampling=sampling or SamplingParams()) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


class _RejectAll:
    """Proposes tokens the greedy chain (almost surely) rejects."""

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, context, k):
        return [(context[-1] + 7919 + i) % self.vocab for i in range(k)]


# -- drafter and accept -----------------------------------------------------


def test_ngram_drafter_matches_jax(jx):
    rng = np.random.RandomState(0)
    for trial in range(200):
        ctx = rng.randint(0, 4, size=rng.randint(0, 24)).tolist()
        k = int(rng.randint(0, 6))
        for n in ((3, 1), (2, 2), (4, 1)):
            got = NgramDrafter(*n).propose(ctx, k)
            assert got == jx.NgramDrafter(*n).propose(ctx, k), (ctx, k, n)
    d = NgramDrafter(max_n=3, min_n=1)
    assert d.propose([1, 2, 3, 9, 9, 1, 2, 3], 3) == [9, 9, 1]
    assert d.propose([1, 2, 5, 1, 2, 7, 1, 2], 1) == [7]
    assert d.propose([], 4) == [] and d.propose([1, 2, 3, 1], 0) == []


def test_spec_accept_tokens_matches_jax_and_the_plain_sampler(jx):
    """Greedy rows: n_acc and the chain equal JAX's on the same logits,
    with drafts that follow the argmax chain for a seeded number of
    lanes. Sampled rows: lane j of the chain is bitwise the port's
    ``sample_tokens`` at step + j, and n_acc counts the leading drafts
    equal to it."""
    rng = np.random.RandomState(1)
    b, k, v = 6, 4, 50
    logits = rng.randn(b, k + 1, v).astype(np.float32)
    greedy = logits.argmax(-1)
    n_good = rng.randint(0, k + 1, size=b)
    drafts = greedy[:, :k].copy()
    for r in range(b):
        drafts[r, n_good[r]:] = (drafts[r, n_good[r]:] + 1) % v
    n_draft = np.array([4, 4, 3, 2, 0, 4], np.int32)
    zeros = np.zeros(b, np.float32)
    suite = (zeros, np.zeros(b, np.int32), np.ones(b, np.float32),
             np.arange(b, dtype=np.int32), np.full(b, 3, np.int32))
    n_acc, chain = spec_accept_tokens(torch.from_numpy(logits), drafts,
                                      n_draft, *suite)
    jn, jchain = jx.accept(jx.jnp.asarray(logits),
                           jx.jnp.asarray(drafts.astype(np.int32)),
                           jx.jnp.asarray(n_draft), *suite)
    assert n_acc.tolist() == np.asarray(jn).tolist()
    assert chain.tolist() == np.asarray(jchain).tolist()
    assert n_acc.tolist() == np.minimum(n_good, n_draft).tolist()
    # sampled rows, mixed filters
    temp = np.array([1.0, 0.7, 0.0, 1.3, 0.9, 1.0], np.float32)
    top_k = np.array([0, 8, 0, 3, 0, 0], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.9, 0.5, 1.0], np.float32)
    seed = np.arange(10, 10 + b, dtype=np.int32)
    step = np.array([0, 5, 9, 2, 7, 1], np.int32)
    lg = torch.from_numpy(logits)
    _, chain = spec_accept_tokens(lg, drafts, n_draft, temp, top_k, top_p,
                                  seed, step)
    for j in range(k + 1):
        want = sample_tokens(lg[:, j], temp, top_k, top_p, seed, step + j)
        assert torch.equal(chain[:, j], want)
    drafts = chain[:, :k].numpy().copy()
    drafts[0, 2] = (drafts[0, 2] + 1) % v
    n_acc, _ = spec_accept_tokens(lg, drafts, n_draft, temp, top_k, top_p,
                                  seed, step)
    assert n_acc.tolist() == [2, 4, 3, 2, 0, 4]


# -- greedy and sampled streams ---------------------------------------------


@pytest.mark.parametrize("name,backend", [
    ("qwen2-0.5b", "paged"), ("qwen2-0.5b", "contiguous"),
    ("granite-moe-1b-a400m", "paged")])
def test_greedy_spec_matches_jax_spec_and_plain(jx, name, backend):
    """Greedy speculative tokens (k = 4, the n-gram drafter) equal the JAX
    speculative engine's and the port's plain engine's; some drafts are
    accepted, so the verify path carries tokens."""
    jcfg, jparams = _jax_setup(jx, name)
    kw = dict(backend=backend, block_size=8)
    jeng = jx.ServeEngine(jcfg, jparams, batch_size=2, max_len=64,
                          spec=jx.SpecConfig(k=4), use_kernel=False,
                          cache_dtype=jx.jnp.float32, **kw)
    jreqs = [jx.Request(prompt=list(p), max_new_tokens=12) for p in PROMPTS]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = _engine(name, SpecConfig(k=4), **kw)
    got = [r.out for r in _serve(eng)]
    assert got == [r.out for r in jreqs]
    assert got == [r.out for r in _serve(_engine(name, **kw))]
    stats = eng.spec_stats()
    assert stats["verify_calls"] == jeng.spec_stats()["verify_calls"]
    assert stats["accepted"] == jeng.spec_stats()["accepted"] > 0
    assert eng.decode_steps == jeng.decode_steps


def test_sampled_spec_matches_plain_stream():
    """At temperature > 0 (top-k and top-p on) the speculative stream
    equals the port's plain stream token for token, on both backends,
    and repeats run to run."""
    sp = SamplingParams(temperature=1.0, top_k=20, top_p=0.9, seed=11)
    for backend in ("paged", "contiguous"):
        base = [r.out for r in _serve(_engine("qwen2-0.5b", backend=backend),
                                      sampling=sp)]
        eng = _engine("qwen2-0.5b", SpecConfig(k=4), backend=backend)
        assert [r.out for r in _serve(eng, sampling=sp)] == base
        assert eng.spec_stats()["drafted"] > 0


# -- rollback ---------------------------------------------------------------


def _pos_pools(eng):
    return [layer["attn"]["pos"] for layer in eng.backend.cache]


@pytest.mark.parametrize("name", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_rollback_pool_equals_never_drafted(name):
    """Every draft rejected: each tick leaves the row's table covering
    exactly positions [0, e.pos] with refcount 1 blocks and every pool
    entry beyond the committed frontier scrubbed to -1; after the run the
    tables, refcounts, free list and pos pools equal a never-drafted
    engine's bitwise, and K/V at live positions within 1e-5 (the verify's
    (B, k+1) products round apart from (B, 1) decode steps in f32)."""
    cfg, _ = _setup(name)
    bs = 4
    spec = SpecConfig(k=4, drafter=_RejectAll(cfg.vocab_size),
                      disable_after_rejects=0)
    eng = _engine(name, spec, backend="paged", block_size=bs,
                  prefix_cache=False)
    plain = _engine(name, backend="paged", block_size=bs,
                    prefix_cache=False)
    req = Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=10)
    eng.submit(req)
    be = eng.backend
    checked = 0
    while not req.done:
        eng.step()
        live = list(eng.sched.live.values())
        if not live or live[0].state != "decode":
            continue
        (e,) = live
        row = be.tables[e.slot]
        want = e.pos // bs + 1
        assert int((row != 0).sum()) == want and (row[want:] == 0).all()
        assert all(be.mgr.ref[int(b)] == 1 for b in row[:want])
        assert be.mgr.num_used == want
        pos0 = _pos_pools(eng)[0]
        for lb, b in enumerate(row[:want]):
            for off in range(bs):
                logical = lb * bs + off
                expect = logical if logical <= e.pos - 1 else -1
                assert int(pos0[int(b), off]) == expect, (lb, off)
        checked += 1
    assert checked >= 5
    stats = eng.spec_stats()
    assert stats["drafted"] > 0 and stats["accepted"] == 0
    ref = Request(prompt=[5, 4, 3, 2, 1], max_new_tokens=10)
    plain.submit(ref)
    plain.run()
    assert req.out == ref.out
    assert np.array_equal(be.tables, plain.backend.tables)
    assert np.array_equal(be.mgr.ref, plain.backend.mgr.ref)
    assert be.mgr._free == plain.backend.mgr._free
    for a, b in zip(be.cache, plain.backend.cache):
        assert torch.equal(a["attn"]["pos"], b["attn"]["pos"])
        live = a["attn"]["pos"] >= 0
        for n in ("k", "v"):
            np.testing.assert_allclose(a["attn"][n][live].numpy(),
                                       b["attn"][n][live].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_eos_finish_reasons_and_preemption():
    """EOS inside an accepted burst truncates it (nothing after EOS is
    recorded or streamed); length, cache_ceiling and eos finish as on the
    plain engine; a pool too small for two rows still finishes both with
    the unconstrained greedy streams."""
    probe = [r.out for r in _serve(_engine("qwen2-0.5b", **PAGED))]
    eos = probe[0][2]
    base = [r.out for r in _serve(_engine("qwen2-0.5b", eos_id=eos,
                                          **PAGED))]
    eng = _engine("qwen2-0.5b", SpecConfig(k=4), eos_id=eos, **PAGED)
    streamed = {}
    reqs = []
    for p in PROMPTS:
        r = Request(prompt=list(p), max_new_tokens=12)
        streamed[id(r)] = []
        r.on_token = lambda req, tok: streamed[id(req)].append(tok)
        reqs.append(r)
        eng.submit(r)
    eng.run()
    assert [r.out for r in reqs] == base
    assert any(r.finish_reason == "eos" for r in reqs)
    for r in reqs:
        assert streamed[id(r)] == r.out
        if r.finish_reason == "eos":
            assert r.out[-1] == eos and eos not in r.out[:-1]
    for spec in (None, SpecConfig(k=4)):
        assert all(r.finish_reason == "length" for r in _serve(
            _engine("qwen2-0.5b", spec, **PAGED), max_new=4))
        eng = _engine("qwen2-0.5b", spec, batch=1, max_len=16, **PAGED)
        r = Request(prompt=list(range(1, 11)), max_new_tokens=32)
        eng.sched.submit(r)  # past submit's check: the defensive path
        eng.run()
        assert r.finish_reason == "cache_ceiling"
        assert len(r.prompt) + len(r.out) == 17
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6]] * 2
    ref = [r.out for r in _serve(_engine("qwen2-0.5b", max_len=32),
                                 prompts)]
    tight = _engine("qwen2-0.5b", SpecConfig(k=4), max_len=32,
                    backend="paged", block_size=4, num_blocks=7,
                    prefix_cache=False)
    assert [r.out for r in _serve(tight, prompts)] == ref
    assert tight.preemptions > 0
    assert tight.backend.mgr.num_used == 0


# -- refusals ---------------------------------------------------------------


def _stub(cfg, backend, max_len=64):
    return types.SimpleNamespace(cfg=cfg, backend=backend, max_len=max_len,
                                 batch=2)


def test_spec_refusals_match_the_reference(jx):
    """Each refusal raises the reference's ValueError with its message:
    an SSM arch, a contiguous ring that wraps, k + 1 above the backend's
    burst limit, and a model without attention (stub engines: no engine
    of either package builds one)."""
    mamba, _ = _setup("mamba2-370m")
    gemma, _ = _setup("gemma3-27b")
    qwen, _ = _setup("qwen2-0.5b")
    jm = jx.reduced(jx.get_config("mamba2-370m"))
    jg = jx.reduced(jx.get_config("gemma3-27b"))
    jq = jx.reduced(jx.get_config("qwen2-0.5b"))

    def contiguous(cls, ring):
        be = object.__new__(cls)
        be.pool = types.SimpleNamespace(min_ring_len=ring)
        return be

    paged = types.SimpleNamespace(max_chunk=64)
    cases = [
        (mamba, jm, paged, paged, SpecConfig(k=4)),
        (gemma, jg, contiguous(ContiguousBackend, 16),
         contiguous(jx.Contiguous, 16), SpecConfig(k=4)),
        (qwen, jq, types.SimpleNamespace(max_chunk=4),
         types.SimpleNamespace(max_chunk=4), SpecConfig(k=4)),
        (dataclasses.replace(qwen, attention=None),
         dataclasses.replace(jq, attention=None), paged, paged,
         SpecConfig(k=4)),
        (qwen, jq, paged, paged, SpecConfig(k=0)),
    ]
    for cfg, jcfg, be, jbe, spec in cases:
        with pytest.raises(ValueError) as got:
            SpecDecoder(_stub(cfg, be), spec)
        with pytest.raises(ValueError) as want:
            jx.SpecDecoder(_stub(jcfg, jbe), jx.SpecConfig(k=spec.k))
        assert str(got.value) == str(want.value)
    # and through the engine
    with pytest.raises(ValueError, match="SSM"):
        _engine("mamba2-370m", SpecConfig(k=4), backend="paged")
    with pytest.raises(ValueError, match="paged"):
        _engine("gemma3-27b", SpecConfig(k=4))


# -- cache_generated and fork_slot ------------------------------------------


def test_cache_generated_hits_match_jax_and_default_off(jx):
    """A two-turn continuation (the first prompt + its output + a new
    turn) gets prefix hits past the first prompt's boundary with
    ``cache_generated``, the same block hits as the JAX paged engine and
    the cold engine's tokens; without the flag it gets none past the
    prompt."""
    prompt = list(range(100, 116))
    jcfg, jparams = _jax_setup(jx, "qwen2-0.5b")
    geo = dict(batch_size=1, max_len=64, backend="paged", block_size=8,
               prefill_chunk=8)
    jeng = jx.ServeEngine(jcfg, jparams, use_kernel=False,
                          cache_dtype=jx.jnp.float32, cache_generated=True,
                          **geo)
    eng = _engine("qwen2-0.5b", cache_generated=True, batch=1,
                  backend="paged", block_size=8, prefill_chunk=8)
    first, jfirst = (Request(prompt=list(prompt), max_new_tokens=10),
                     jx.Request(prompt=list(prompt), max_new_tokens=10))
    eng.submit(first)
    eng.run()
    jeng.submit(jfirst)
    jeng.run()
    assert first.out == jfirst.out
    follow = prompt + first.out + [7, 8]
    r, jr = (Request(prompt=list(follow), max_new_tokens=6),
             jx.Request(prompt=list(follow), max_new_tokens=6))
    eng.submit(r)
    eng._admit()
    (entry,) = eng.sched.live.values()
    assert entry.start_pos > len(prompt)
    eng.run()
    jeng.submit(jr)
    jeng.run()
    assert r.out == jr.out
    assert eng.backend.prefix.hits == jeng.backend.prefix.hits
    cold = _engine("qwen2-0.5b", batch=1, backend="paged", block_size=8)
    (c,) = _serve(cold, [follow], 6)
    assert c.out == r.out
    off = _engine("qwen2-0.5b", batch=1, backend="paged", block_size=8,
                  prefill_chunk=8)
    assert not off.backend.cache_generated
    (f,) = _serve(off, [prompt], 10)
    off.submit(Request(prompt=f.prompt + f.out + [7], max_new_tokens=2))
    off._admit()
    (entry,) = off.sched.live.values()
    assert entry.start_pos <= len(prompt)
    with pytest.raises(ValueError, match="paged"):
        _engine("qwen2-0.5b", cache_generated=True)


def test_fork_slot_copy_on_write():
    """A forked row shares every block of its source (refcount 2, tables
    equal) until a write. Decoded greedily beside its source through the
    backend, its first write copies the shared last block, both rows give
    the plain engine's tokens, and retiring both frees every block; with
    no slot free the fork returns None."""
    max_new = 6
    prompt = [5, 6, 7, 8, 9, 10]
    (want,) = _serve(_engine("qwen2-0.5b", **PAGED), [prompt], max_new)
    eng = _engine("qwen2-0.5b", backend="paged", block_size=4,
                  prefix_cache=False)
    be = eng.backend
    eng.submit(Request(prompt=list(prompt), max_new_tokens=max_new))
    while not eng.sched.decode_entries():
        eng.step()
    (e,) = eng.sched.live.values()
    src = e.slot
    shared = [int(b) for b in be.tables[src] if b]
    clone = be.fork_slot(src)
    assert clone is not None and clone != src
    assert np.array_equal(be.tables[clone], be.tables[src])
    assert all(be.mgr.ref[b] == 2 for b in shared)
    used = be.mgr.num_used
    rows = [src, clone]
    logits = eng._logits[[src, src]]
    pos = e.pos
    done = list(e.req.out)  # emitted by the engine before the fork
    outs = [list(done), list(done)]
    n = max_new - len(done)
    for step in range(n):
        toks = logits.argmax(-1)
        for i in range(2):
            outs[i].append(int(toks[i]))
        if step == n - 1:
            break
        for slot in rows:
            assert be.ensure_decode_block(slot, pos)
        if step == 0:  # the shared last block was copied for one row
            assert be.mgr.num_used == used + 1
            assert be.tables[src][pos // 4] != be.tables[clone][pos // 4]
        in_toks = torch.zeros(2, 1, dtype=torch.long)
        in_pos = torch.full((2,), -1, dtype=torch.int32)
        in_toks[rows, 0] = toks
        in_pos[rows] = pos
        logits = be.decode(eng.params, in_toks, in_pos)[rows, 0]
        pos += 1
    assert outs[0] == outs[1] == want.out
    for slot in rows:
        be.retire(slot)
    assert be.mgr.num_used == 0
    full = _engine("qwen2-0.5b", batch=1, backend="paged", block_size=4)
    full.submit(Request(prompt=[1, 2], max_new_tokens=2))
    full._admit()
    assert full.backend.fork_slot(0) is None  # no slot free
