"""The port's wave-synchronous baseline engine (``serve.WaveEngine``)
against the JAX package's, on reduced qwen2-0.5b in f32 with the JAX
params converted by ``convert.py``:

- its greedy tokens equal the JAX ``WaveEngine``'s on the prompts of
  ``tests/test_serve.py::test_continuous_matches_wave_greedy`` (batch 2,
  4 new tokens: two waves, the first with rows of unequal length, so the
  right-aligned pads at position -1 are exercised), and the port's
  continuous ``ServeEngine``'s (that test's contract);
- three identical requests give identical streams and all finish
  (``test_wave_engine_still_generates``);
- a wave cut by ``max_len`` ends with ``cache_ceiling``;
- ``peak_cache_bytes()`` equals the bytes of a real ``init_cache`` and
  allocates nothing.

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
from repro_torch.models import init_cache
from repro_torch.serve import Request, ServeEngine, WaveEngine

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 4, 4]]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import lm_init as jlm_init
    from repro.serve import Request as JRequest
    from repro.serve import WaveEngine as JWaveEngine

    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-0.5b")),
                               dtype="float32")
    jparams = jax.jit(lambda k: jlm_init(k, jcfg))(jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        jax=jax, cfg=jcfg, params=jparams, Request=JRequest,
        WaveEngine=JWaveEngine)


@pytest.fixture(scope="module")
def port(jx):
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              dtype="float32")
    tree = jx.jax.tree_util.tree_map(np.asarray, jx.params)
    return cfg, params_from_jax(tree, cfg, device="cpu")


def _serve(eng, prompts, max_new, request=Request):
    reqs = [request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


def test_wave_greedy_equals_jax_and_continuous(jx, port):
    cfg, params = port
    want = _serve(jx.WaveEngine(jx.cfg, jx.params, batch_size=2,
                                max_len=64), PROMPTS, 4, jx.Request)
    eng = WaveEngine(cfg, params, batch_size=2, max_len=64, device="cpu")
    got = _serve(eng, PROMPTS, 4)
    assert [r.out for r in got] == [r.out for r in want]
    assert [r.finish_reason for r in got] == ["length"] * 3
    assert eng.decode_steps == 2 * 3  # two waves of 3 lockstep steps
    cont = _serve(ServeEngine(cfg, params, batch_size=2, max_len=64,
                              device="cpu"), PROMPTS, 4)
    assert [r.out for r in cont] == [r.out for r in got]


def test_identical_requests_identical_streams(port):
    cfg, params = port
    eng = WaveEngine(cfg, params, batch_size=2, max_len=64, device="cpu")
    reqs = _serve(eng, [[1, 2, 3]] * 3, 4)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert reqs[0].out == reqs[1].out == reqs[2].out
    assert all(r.t_submit <= r.t_first_token <= r.t_done for r in reqs)


def test_max_len_cuts_a_wave_at_the_cache_ceiling(port):
    """Prompt 5 + the first token at prefill, then decode steps at
    positions 5..9: the wave stops when a row reaches ``max_len`` 10 with
    6 of its 8 tokens; the shorter row ends there too."""
    cfg, params = port
    eng = WaveEngine(cfg, params, batch_size=2, max_len=10, device="cpu")
    reqs = _serve(eng, [[1, 2, 3, 4, 5], [7, 8]], 8)
    assert [r.finish_reason for r in reqs] == ["cache_ceiling"] * 2
    assert [len(r.out) for r in reqs] == [6, 6]
    assert eng.decode_steps == 5


def test_peak_cache_bytes_is_a_real_cache_and_allocates_nothing(port,
                                                               monkeypatch):
    cfg, params = port
    eng = WaveEngine(cfg, params, batch_size=3, max_len=40, device="cpu")
    cache = init_cache(cfg, 3, 40, device="cpu")
    want = sum(t.numel() * t.element_size()
               for layer in cache for part in layer.values()
               for t in part.values())
    made = []
    real_zeros, real_full = torch.zeros, torch.full

    def zeros(*a, **kw):
        made.append(kw.get("device"))
        return real_zeros(*a, **kw)

    def full(*a, **kw):
        made.append(kw.get("device"))
        return real_full(*a, **kw)

    monkeypatch.setattr(torch, "zeros", zeros)
    monkeypatch.setattr(torch, "full", full)
    assert eng.peak_cache_bytes() == want
    assert made and all(str(d) == "meta" for d in made)
    # a wave cache of ~2.7 TB reports its size without allocating it
    huge = WaveEngine(cfg, params, batch_size=1024, max_len=1 << 24,
                      device="cpu")
    assert huge.peak_cache_bytes() == want // (3 * 40) * 1024 * (1 << 24)
