"""The port's contiguous ring cache against the JAX package, in f32:

- ``init_kv_cache`` (GQA on a sliding-window layer and a global one,
  MLA), ``_ring_update`` and ``reset_kv_rows`` against the JAX ones from
  the same ring state: decode steps with an inactive row, a left-padded
  chunk, shared (S,) positions, and a whole-prompt prefill longer than
  the ring, where two tokens of a row map to one slot and the highest
  position wins. ``pos`` exact, values within 1e-4;
- one GQA layer (window 16, local and global) and one MLA layer on the
  ring: whole-prompt prefill, a chunk continuation and decode steps,
  outputs and rings against the JAX layer;
- every reduced decoder-only ``ASSIGNED`` arch: prefill + token-by-token
  decode through ``init_cache`` against the JAX ``lm_apply`` on the same
  weights (1e-4), against the port's own full forward (2e-2, as
  ``tests/test_models_smoke.py::test_arch_decode_consistency``), and
  row i of the batched decode bitwise equal to the decode of row i alone
  (the other row inactive, position -1, at the same batch shape). A
  true batch-1 decode is held within 1e-5 of max|ref|: at one row the
  CPU's matmuls take another path (a GEMV) whose sums round apart from
  the two-row GEMM's, by ~2e-7 (hymba's random weights amplify it to
  ~1.5e-6), without any row reading another's.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, get_config, reduced
from repro_torch.layers import attention as tattn
from repro_torch.models import init_cache, lm_apply, lm_init, segment_plan
from repro_torch.optim import tree_map

TOL = 1e-4
ARCHS = [c.name for c in ASSIGNED if c.encoder_layers == 0]


def _cfg(get, red, name):
    """Reduced f32 config; sparse MoE with slack capacity, as the JAX
    decode-consistency test has it."""
    cfg = dataclasses.replace(red(get(name)), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.layers import attention as jattn
    from repro.models import init_cache as jinit_cache
    from repro.models import lm_apply as jlm_apply

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, attn=jattn, get_config=jget_config,
        reduced=jreduced, init_cache=jinit_cache, lm_apply=jlm_apply)


def _np(t):
    return t.detach().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _ring_equal(got, want):
    """The port's ring (torch) against the JAX one: pos exact, values
    within TOL."""
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        if k == "pos":
            np.testing.assert_array_equal(_np(got[k]), w)
        else:
            np.testing.assert_allclose(_np(got[k]), w, rtol=TOL, atol=TOL)


def _random_ring(jx, cfg, is_global, batch=2, length=16, seed=0):
    """A JAX ring with random values and a mix of valid and -1 positions,
    and the port's copy of it."""
    jring = jx.attn.init_kv_cache(cfg, batch, length, is_global,
                                  jx.jnp.float32)
    rng = np.random.RandomState(seed)
    jring = {k: (rng.randint(-1, 40, v.shape).astype(np.int32) if k == "pos"
                 else rng.standard_normal(v.shape).astype(np.float32))
             for k, v in jring.items()}
    return ({k: jx.jnp.asarray(v) for k, v in jring.items()},
            {k: _t(v) for k, v in jring.items()})


@pytest.mark.parametrize("name,is_global", [
    ("gemma3-27b", False), ("gemma3-27b", True),
    ("deepseek-v2-lite-16b", True)])
def test_init_kv_cache_matches_jax(jx, name, is_global):
    """Shapes, dtypes and the all -1 ``pos``: a local layer's ring is
    min(length, window) long, a global one's the whole length."""
    cfg = _cfg(get_config, reduced, name)
    jcfg = _cfg(jx.get_config, jx.reduced, name)
    for length in (8, 40):
        got = tattn.init_kv_cache(cfg, 3, length, is_global, torch.float32,
                                  device="cpu")
        want = jx.attn.init_kv_cache(jcfg, 3, length, is_global,
                                     jx.jnp.float32)
        _ring_equal(got, want)
        want_len = length if is_global or name != "gemma3-27b" else \
            min(length, 16)
        assert got["pos"].shape == (3, want_len)
        assert got["pos"].dtype == torch.int32


def _update_cases():
    """(positions (B,S) or (S,), label): ring length 16."""
    return [
        (np.array([[17], [-1]]), "decode, an inactive row"),
        (np.array([[-1, -1, 3, 4, 5], [30, 31, 32, 33, 34]]),
         "left-padded chunk, one row wrapping"),
        (np.arange(5, 12), "shared positions"),
        (np.stack([np.arange(40), np.r_[[-1] * 7, np.arange(33)]]),
         "prefill of 40 over a ring of 16: duplicate slots"),
    ]


@pytest.mark.parametrize("name", ["gemma3-27b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("case", range(4))
def test_ring_update_matches_jax(jx, name, case):
    """``_ring_update`` from the same random ring: pos exact, values
    within 1e-4, the highest position winning a shared slot and tokens at
    position < 0 leaving entry and pos untouched."""
    cfg = _cfg(get_config, reduced, name)
    positions, _ = _update_cases()[case]
    jring, ring = _random_ring(jx, cfg, is_global=False)
    s = positions.shape[-1]
    rng = np.random.RandomState(case + 1)
    names = [k for k in ring if k != "pos"]
    vals = {k: rng.standard_normal((2, s) + ring[k].shape[2:]).astype(
        np.float32) for k in names}
    want = jx.attn._ring_update(
        jring, {k: jx.jnp.asarray(v) for k, v in vals.items()},
        jx.jnp.asarray(positions.astype(np.int32)))
    before = {k: v.clone() for k, v in ring.items()}
    out = tattn._ring_update(ring, {k: _t(v) for k, v in vals.items()},
                             _t(positions.astype(np.int32)))
    assert out is ring
    _ring_equal(ring, want)
    if case == 0:  # the inactive row is bitwise as it was
        for k in ring:
            assert torch.equal(ring[k][1], before[k][1])
    if case == 3:  # each slot holds the last of the tokens that map to it
        np.testing.assert_array_equal(_np(ring["pos"][0]),
                                      np.arange(24, 40)[np.argsort(
                                          np.arange(24, 40) % 16)])


def test_reset_kv_rows_matches_jax(jx):
    cfg = _cfg(get_config, reduced, "qwen2-0.5b")
    jring, ring = _random_ring(jx, cfg, is_global=True, batch=3)
    want = jx.attn.reset_kv_rows(jring, 1)
    before = {k: v.clone() for k, v in ring.items()}
    assert tattn.reset_kv_rows(ring, 1) is ring
    _ring_equal(ring, want)
    assert (ring["pos"][1] == -1).all()
    for k in ring:  # the other rows, and row 1's values, are untouched
        assert torch.equal(ring[k][0], before[k][0])
        assert torch.equal(ring[k][2], before[k][2])
        if k != "pos":
            assert torch.equal(ring[k][1], before[k][1])


def _layer_calls():
    """(positions (2, S), mode): a whole-prompt prefill of 20 (row 1
    left-padded by 3) past a window of 16, a chunk continuation of 5,
    then 3 decode steps, one with row 1 inactive."""
    pre = np.stack([np.arange(20), np.r_[[-1] * 3, np.arange(17)]])
    calls = [(pre, "prefill"),
             (np.stack([np.arange(20, 25), np.arange(17, 22)]), "decode")]
    for t, (p0, p1) in enumerate(((25, 22), (26, -1), (27, 23))):
        calls.append((np.array([[p0], [p1]]), "decode"))
    return calls


@pytest.mark.parametrize("name,is_global", [
    ("gemma3-27b", False), ("gemma3-27b", True),
    ("deepseek-v2-lite-16b", True)])
def test_ring_layer_matches_jax(jx, name, is_global):
    """One attention layer over the ring, call by call, output and ring
    within 1e-4 of the JAX layer (a ring of 32: 16 on gemma3's local
    layer)."""
    cfg = _cfg(get_config, reduced, name)
    jcfg = _cfg(jx.get_config, jx.reduced, name)
    jparams = jx.attn.attention_init(jx.jax.random.PRNGKey(2), jcfg)
    params = {k: _t(v) for k, v in jparams.items()}
    layer = jx.jax.jit(
        lambda p, x, pos, c, mode: jx.attn.attention_apply(
            p, jcfg, x, layer_is_global=is_global, positions=pos, cache=c,
            mode=mode), static_argnames="mode")
    jring = jx.attn.init_kv_cache(jcfg, 2, 32, is_global, jx.jnp.float32)
    ring = tattn.init_kv_cache(cfg, 2, 32, is_global, torch.float32,
                               device="cpu")
    rng = np.random.RandomState(4)
    for positions, mode in _layer_calls():
        x = rng.standard_normal((2, positions.shape[1], cfg.d_model)).astype(
            np.float32)
        want, jring = layer(jparams, x, positions.astype(np.int32), jring,
                            mode=mode)
        got, out_ring = tattn.attention_apply(
            params, cfg, _t(x), layer_is_global=is_global,
            positions=_t(positions.astype(np.int32)), cache=ring, mode=mode)
        assert out_ring is ring
        live = positions >= 0
        np.testing.assert_allclose(_np(got)[live], np.asarray(want)[live],
                                   rtol=TOL, atol=TOL)
        _ring_equal(ring, jring)


def _jax_tree(params, cfg):
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][start:start + count])
        for start, count, _ in segment_plan(cfg)]
    return tree


def _decode_run(cfg, params, toks, embeds, cache, split, live=None):
    """Prefill ``toks[:, :split]`` (with the frontend's embeddings
    prepended), then decode the rest token by token; returns the logits
    of the prefill's last position and each decode step, (B, S-split+1,
    V). With ``live`` (a row index) every other row carries position -1
    throughout: inactive, as the engine runs a row alone."""
    n_prefix = 0 if embeds is None else embeds.shape[1]
    b, s = toks.shape

    def pos(a, z):
        p = torch.arange(a, z)[None].repeat(b, 1)
        if live is not None:
            p[torch.arange(b) != live] = -1
        return p

    lp, _, _ = lm_apply(params, cfg, toks[:, :split], embeds=embeds,
                        positions=pos(0, split + n_prefix),
                        cache=cache, mode="prefill")
    outs = [lp[:, -1]]
    for t in range(split, s):
        lt, _, _ = lm_apply(params, cfg, toks[:, t:t + 1],
                            positions=pos(n_prefix + t, n_prefix + t + 1),
                            cache=cache, mode="decode")
        outs.append(lt[:, 0])
    return torch.stack(outs, 1)


@pytest.mark.parametrize("name", ARCHS)
def test_arch_ring_decode_matches_jax(jx, name):
    """Prefill of 20 (plus the frontend's embeddings) and 4 decode steps
    through ``init_cache``, on 2 rows: against the JAX ``lm_apply`` on the
    same weights and cache (1e-4), against the port's full forward (2e-2
    of max|ref|), the rings and SSM rows equal to the JAX cache; row i
    bitwise equal to row i decoded alone (the other row inactive), and
    within 1e-5 of a batch-1 decode."""
    cfg = _cfg(get_config, reduced, name)
    jcfg = _cfg(jx.get_config, jx.reduced, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = lm_init(torch.Generator().manual_seed(ARCHS.index(name)), cfg)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                        _jax_tree(params, cfg))
    rng = np.random.RandomState(1)
    b, s, split = 2, 24, 20
    toks = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    embeds = None
    if cfg.frontend.kind != "none":
        embeds = rng.standard_normal(
            (b, cfg.frontend.num_embeds, cfg.frontend.embed_dim)).astype(
                np.float32)
    n_prefix = 0 if embeds is None else embeds.shape[1]
    max_len = s + n_prefix

    cache = init_cache(cfg, b, max_len, torch.float32, device="cpu")
    te = None if embeds is None else _t(embeds)
    got = _decode_run(cfg, params, _t(toks).long(), te, cache, split)

    prefill = jx.jax.jit(lambda p, t, e, c: jx.lm_apply(
        p, jcfg, t, embeds=e, positions=jx.jnp.arange(split + n_prefix),
        cache=c, mode="prefill")[:2])
    decode = jx.jax.jit(lambda p, t, pos, c: jx.lm_apply(
        p, jcfg, t, positions=pos, cache=c, mode="decode")[:2])
    jcache = jx.init_cache(jcfg, b, max_len, jx.jnp.float32)
    lp, jcache = prefill(jparams, toks[:, :split], embeds, jcache)
    want = [lp[:, -1]]
    for t in range(split, s):
        lt, jcache = decode(jparams, toks[:, t:t + 1],
                            jx.jnp.arange(n_prefix + t, n_prefix + t + 1),
                            jcache)
        want.append(lt[:, 0])
    want = np.stack([np.asarray(w) for w in want], 1)
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)
    for layer, jlayer in zip(cache, jcache):
        assert set(layer) == set(jlayer)
        if "attn" in layer:
            _ring_equal(layer["attn"], jlayer["attn"])
        for k, v in layer.get("ssm", {}).items():
            np.testing.assert_allclose(_np(v), np.asarray(jlayer["ssm"][k]),
                                       rtol=TOL, atol=TOL)

    full = lm_apply(params, cfg, _t(toks).long(), embeds=te)[0]
    ref = full[:, n_prefix + split - 1:]
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel < 2e-2, f"{name}: decode vs full forward rel={rel:.3e}"

    for i in range(b):
        solo = init_cache(cfg, b, max_len, torch.float32, device="cpu")
        alone = _decode_run(cfg, params, _t(toks).long(), te, solo, split,
                            live=i)
        assert torch.equal(alone[i], got[i]), f"{name}: row {i}"
        one = init_cache(cfg, 1, max_len, torch.float32, device="cpu")
        b1 = _decode_run(cfg, params, _t(toks[i:i + 1]).long(),
                         None if te is None else te[i:i + 1], one, split)
        rel = float((b1[0] - got[i]).abs().max() / got[i].abs().max())
        assert rel < 1e-5, f"{name}: row {i} vs batch 1, rel={rel:.3e}"
