"""The port's paged serving against the JAX package: host-side
BlockManager / RadixPrefixCache cases (the copies must behave as the
originals), greedy token-for-token parity of ``ServeEngine(
backend="paged")`` with the JAX engine under prefix hits and preemption,
and kernel-route vs gather-route parity inside the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm_init as jax_lm_init
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.block_manager import BlockManager as JaxBlockManager
from repro.serve.prefix_cache import RadixPrefixCache as JaxRadixPrefixCache
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.serve import (
    BlockManager,
    RadixPrefixCache,
    Request,
    SamplingParams,
    ServeEngine,
)
from repro_torch.serve.sampling import sample_tokens

BS = 4


def _prompt(*blocks):
    return [b * 100 + i for b in blocks for i in range(BS)]


def _insert_chain(tree, mgr, tokens):
    n_full = len(tokens) // BS
    blocks = mgr.alloc(n_full)
    tree.insert(tokens[: n_full * BS], blocks, mgr)
    return blocks


# -- host-side cases: each runs on the port's classes and on the JAX
# package's, and both must leave the same observable state ---------------


def case_alloc_free_roundtrip(mgr_cls, tree_cls):
    m = mgr_cls(5)
    a = m.alloc(2)
    assert 0 not in a and m.num_free == 2 and m.num_used == 2
    for b in a:
        assert m.decref(b)
    return sorted(m.alloc(4)), m.num_free, m.high_water


def case_refcount_and_cow(mgr_cls, tree_cls):
    m = mgr_cls(8)
    table = m.alloc(3) + [0, 0]
    clone = m.fork_table(table)
    shared = [m.needs_cow(b) for b in table if b != 0]
    (new,) = m.alloc(1)
    m.decref(clone[1])
    clone[1] = new
    for b in table + clone:
        if b != 0:
            m.decref(b)
    return shared, m.num_used, list(m.ref)


def case_null_block_pinned(mgr_cls, tree_cls):
    m = mgr_cls(3)
    for bad in (m.incref, m.decref):
        with pytest.raises(AssertionError):
            bad(0)
    seen = []
    for _ in range(3):
        blocks = m.alloc(2)
        seen.append(blocks)
        for b in blocks:
            m.decref(b)
    return seen


def case_match_and_last_token_cap(mgr_cls, tree_cls):
    mgr, tree = mgr_cls(32), tree_cls(BS)
    toks = _prompt(1, 2, 3)
    blocks = _insert_chain(tree, mgr, toks)
    return (blocks, tree.match(toks + [999]), tree.match(_prompt(1, 2, 9)),
            tree.match(toks), tree.match(toks[:BS]), list(mgr.ref))


def case_dedup_keeps_incumbent(mgr_cls, tree_cls):
    mgr, tree = mgr_cls(32), tree_cls(BS)
    toks = _prompt(1, 2)
    first = _insert_chain(tree, mgr, toks)
    adopted = tree.insert(toks, mgr.alloc(2), mgr)
    return first, adopted, tree.match(toks + [5]), list(mgr.ref)


def case_lru_eviction_order(mgr_cls, tree_cls):
    mgr, tree = mgr_cls(64), tree_cls(BS)
    chains = {i: _insert_chain(tree, mgr, _prompt(10 + i))[0]
              for i in range(8)}
    for b in chains.values():
        mgr.decref(b)
    for i in [3, 5, 0, 7, 2, 6, 1, 4]:
        tree.match(_prompt(10 + i) + [0])
    for i in (3, 5):
        mgr.incref(chains[i])  # pinned: eviction must skip them
    freed = []
    while tree.evict_one(mgr):
        freed.append([i for i, b in chains.items() if mgr.ref[b] == 0])
    for i in (3, 5):
        mgr.decref(chains[i])
    n_after = tree.evict_all_unreferenced(mgr)
    return freed, n_after, len(tree), mgr.num_used


def case_hit_stats(mgr_cls, tree_cls):
    mgr, tree = mgr_cls(16), tree_cls(BS)
    _insert_chain(tree, mgr, _prompt(1, 2))
    got = tree.match(_prompt(1, 2) + [0])
    tree.match(_prompt(1, 2) + [0])  # a retry counts nothing
    tree.record_lookup(len(got))
    tree.record_lookup(len(tree.match(_prompt(5) + [0])))
    return tree.hits, tree.misses


HOST_CASES = [case_alloc_free_roundtrip, case_refcount_and_cow,
              case_null_block_pinned, case_match_and_last_token_cap,
              case_dedup_keeps_incumbent, case_lru_eviction_order,
              case_hit_stats]


@pytest.mark.parametrize("case", HOST_CASES, ids=lambda c: c.__name__[5:])
def test_host_side_copies_behave_as_jax(case):
    assert (case(BlockManager, RadixPrefixCache)
            == case(JaxBlockManager, JaxRadixPrefixCache))


# -- engine parity ----------------------------------------------------------


def _qwen_pair():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                               dtype="float32")
    jparams = jax_lm_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts():
    """Mixed lengths (29, 33, 3, 40, 17 tokens); prompts 0 and 1 share a
    24-token prefix."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 256, 24).tolist()
    p0 = shared + rng.randint(1, 256, 5).tolist()
    short, long_, mid = (rng.randint(1, 256, n).tolist() for n in (3, 40, 17))
    return [p0, shared + rng.randint(1, 256, 9).tolist(), short, long_, mid]


# 7 usable blocks of 8 tokens: prompt 1 (5 blocks) waits until prompt 0
# (4 blocks) has prefilled and published the shared prefix, and rows
# growing past their blocks preempt each other.
GEO = dict(batch_size=2, max_len=64, block_size=8, num_blocks=8)


def test_engine_greedy_tokens_match_jax_engine():
    """Greedy streams equal the JAX paged engine's token for token, with
    a radix prefix hit and preemptions in both engines. The JAX engine
    runs its gather path, the bit-exact oracle of its kernel."""
    jcfg, tcfg, jparams, tparams = _qwen_pair()
    prompts = _prompts()
    jeng = JaxServeEngine(jcfg, jparams, backend="paged", use_kernel=False,
                          cache_dtype=jnp.float32, **GEO)
    teng = ServeEngine(tcfg, tparams, cache_dtype=torch.float32,
                       device="cpu", backend="paged", **GEO)
    outs = []
    for eng, req in ((jeng, JaxRequest), (teng, Request)):
        reqs = [req(prompt=p, max_new_tokens=10) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.finish_reason == "length" for r in reqs)
        assert eng.backend.prefix.hits >= 1
        assert eng.preemptions >= 1
        outs.append(([r.out for r in reqs], eng.decode_steps,
                     eng.preemptions, eng.backend.prefix.hits))
    assert outs[1] == outs[0]


def test_kernel_route_matches_gather_route_in_the_port():
    _, tcfg, _, tparams = _qwen_pair()
    outs = []
    for use_kernel in (True, False):
        eng = ServeEngine(tcfg, tparams, use_kernel=use_kernel,
                          cache_dtype=torch.float32, device="cpu",
                          batch_size=3, max_len=64, block_size=8,
                          backend="paged")
        reqs = [Request(prompt=p, max_new_tokens=6) for p in _prompts()]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


def test_sampling_is_per_request_and_batch_independent():
    """A sampled row's draw depends only on its (seed, step) and logits,
    not on its slot or its neighbours; greedy rows take the argmax."""
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(3, 50).astype(np.float32))
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=7)
    temp = np.array([0.0, sp.temperature, sp.temperature], np.float32)
    args = (temp, np.array([0, sp.top_k, sp.top_k]),
            np.array([1.0, sp.top_p, sp.top_p], np.float32),
            np.array([0, sp.seed, sp.seed]), np.array([0, 3, 3]))
    toks = sample_tokens(logits, *args)
    assert int(toks[0]) == int(torch.argmax(logits[0]))
    solo = sample_tokens(logits[2:], *(a[2:] for a in args))
    assert int(solo[0]) == int(toks[2])
    shuffled = sample_tokens(logits[[2, 1, 0]], *(a[[2, 1, 0]] for a in args))
    assert shuffled.tolist() == toks[[2, 1, 0]].tolist()


def test_cancel_deadline_and_poisoned_row_release_everything():
    """A cancelled live row, a queued request past its deadline and a row
    whose logits turn non-finite all retire within the tick with their
    reason, and the pool drains to the prefix tree's blocks only; the
    other requests still finish."""
    _, tcfg, _, tparams = _qwen_pair()
    eng = ServeEngine(tcfg, tparams, cache_dtype=torch.float32,
                      device="cpu", batch_size=3, max_len=64, block_size=8,
                      backend="paged")
    p = _prompts()
    keep = Request(prompt=p[2], max_new_tokens=8)
    live = Request(prompt=p[3], max_new_tokens=8)
    poisoned = Request(prompt=p[4], max_new_tokens=8)
    late = Request(prompt=p[0], max_new_tokens=4, deadline_s=0.0)
    for r in (keep, live, poisoned, late):
        eng.submit(r)
    eng.step()  # admits three; `late` stays queued and expires next tick
    while not eng.sched.entry_for(poisoned) or len(poisoned.out) == 0:
        eng.step()
    assert late.finish_reason == "deadline"
    slot = eng.sched.entry_for(poisoned).slot
    eng._logits[slot] = float("nan")
    assert eng.cancel(live) and live.finish_reason == "cancelled"
    assert eng.sched.entry_for(live) is None
    eng.run()
    assert poisoned.finish_reason == "error" and eng.nonfinite_retired == 1
    assert keep.finish_reason == "length" and len(keep.out) == 8
    assert not eng.cancel(keep)  # already finished
    assert eng.backend.tables.sum() == 0
    assert eng.backend.mgr.num_used == len(eng.backend.prefix)
