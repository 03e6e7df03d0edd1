"""The port's encoder-decoder (reduced ``seamless-m4t-large-v2``) against
the JAX package on the same f32 weights, mirroring
``tests/test_encdec.py``:

- ``encode``, ``encdec_apply`` and ``encdec_loss`` with its gradients
  (``jax.grad``), without and with remat, within 1e-4;
- the cached decode (``init_encdec_cache``: a whole-prompt prefill, then
  decode steps reading each layer's cached cross K/V) against the JAX
  cached decode within 1e-4 and against the full forward within 2e-2
  (the reference's own bound), and the cross K/V computed once;
- the softified encoder (``softify(cfg, num_experts=4)``): loss and
  gradients, finite and equal to the JAX ones;
- ``params_from_jax`` and ``train_state_from_jax`` on the enc-dec tree,
  ``build_model``'s triple, the chunked cross-attention path (the
  threshold lowered in both packages), ``lm_init``/``lm_apply`` on the
  decoder stack with the audio frontend prepended, and
  ``SyntheticSeq2Seq``'s fields, shapes, dtypes and vocabulary range.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced, softify
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import SyntheticSeq2Seq
from repro_torch.layers import attention as tattn
from repro_torch.models import (
    build_model,
    encdec_apply,
    encdec_init,
    encdec_loss,
    init_encdec_cache,
    lm_apply,
    lm_init,
    segment_plan,
)
from repro_torch.models import encdec as tencdec
from repro_torch.optim import tree_leaves, tree_map

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4
B, S = 2, 12


def _cfg(get, red, soft=False, **kw):
    cfg = get(ARCH)
    if soft:
        cfg = _softify(cfg)
    return dataclasses.replace(red(cfg), dtype="float32", **kw)


def _softify(cfg):
    return softify(cfg, num_experts=4)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.configs import softify as jsoftify
    from repro.layers import attention as jattn
    from repro.models import encdec as jencdec

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget_config,
                                 reduced=jreduced, softify=jsoftify,
                                 attn=jattn, encdec=jencdec)


def _jcfg(jx, soft=False, **kw):
    cfg = jx.get_config(ARCH)
    if soft:
        cfg = jx.softify(cfg, num_experts=4)
    return dataclasses.replace(jx.reduced(cfg), dtype="float32", **kw)


def _jax_tree(params, cfg):
    """The port's enc-dec params in the JAX layout: the encoder layers of
    each homogeneous run stacked under ``"enc_segments"``."""
    np_ = lambda t: t.detach().numpy()  # noqa: E731
    tree = {k: tree_map(np_, v) for k, v in params.items()
            if k not in ("enc_layers", "dec_blocks")}
    enc = tencdec._enc_cfg(cfg)
    tree["enc_segments"] = [
        tree_map(lambda *ts: np.stack([np_(t) for t in ts]),
                 *params["enc_layers"][start:start + count])
        for start, count, _ in segment_plan(enc)]
    tree["dec_blocks"] = [tree_map(np_, b) for b in params["dec_blocks"]]
    return tree


def _setup(jx, soft=False, **kw):
    """Config pair, the port's params, the JAX params (from the port's,
    checked against ``jax.eval_shape`` of the JAX ``encdec_init``), and
    a batch of tokens and frames."""
    cfg, jcfg = _cfg(get_config, reduced, soft, **kw), _jcfg(jx, soft, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = encdec_init(torch.Generator().manual_seed(int(soft)), cfg)
    tree = _jax_tree(params, cfg)
    want = jx.jax.eval_shape(lambda k: jx.encdec.encdec_init(k, jcfg),
                             jx.jax.random.PRNGKey(0))
    got_l, got_d = jx.jax.tree_util.tree_flatten(tree)
    want_l, want_d = jx.jax.tree_util.tree_flatten(want)
    assert got_d == want_d
    assert [(a.shape, a.dtype) for a in got_l] == \
        [(a.shape, a.dtype) for a in want_l]
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.frontend.num_embeds, cfg.frontend.embed_dim)).astype(
            np.float32)
    return cfg, jcfg, params, jparams, toks, frames


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _grads(params, cfg, batch):
    """The port's loss and gradients, in the JAX layout."""
    wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = encdec_loss(wrt, cfg, batch)
    leaves = tree_leaves(wrt)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, metrics, _jax_tree(tree_map(lambda _: next(it), wrt), cfg)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_loss_and_grads_match_jax(jx, remat):
    """``encode``, ``encdec_apply`` and ``encdec_loss`` with its gradients
    against JAX within 1e-4 (remat runs the encoder blocks under
    activation checkpointing in the port and ``jax.checkpoint`` in JAX)."""
    cfg, jcfg, params, jparams, toks, frames = _setup(jx, remat=remat)
    enc, aux = tencdec.encode(params, cfg, _t(frames))
    jenc, jaux = jx.jax.jit(lambda p, f: jx.encdec.encode(p, jcfg, f))(
        jparams, frames)
    close(enc, jenc)
    assert float(aux) == float(jaux) == 0.0
    logits, (enc_out, cache), _ = encdec_apply(params, cfg, _t(toks).long(),
                                               _t(frames))
    assert cache is None and torch.equal(enc_out, enc)
    jlogits = jx.jax.jit(lambda p, t, f: jx.encdec.encdec_apply(
        p, jcfg, t, f)[0])(jparams, toks, frames)
    assert logits.shape == (B, S, cfg.vocab_size)
    close(logits, jlogits)
    batch = {"tokens": _t(toks).long(), "embeds": _t(frames)}
    loss, metrics, grads = _grads(params, cfg, batch)
    (jloss, jmetrics), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.encdec.encdec_loss(p, jcfg, b), has_aux=True))(
            jparams, {"tokens": toks, "embeds": frames})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics) == {"loss", "aux_loss"}
    for g, w in zip(jx.jax.tree_util.tree_leaves(grads),
                    jx.jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def _cached_decode(apply, enc_out, toks, cache, arange, split):
    """Whole-prompt prefill of ``toks[:, :split]``, then decode steps;
    returns the stacked logits of the prefill's last position and every
    step, and the cache."""
    lp, (_, cache), _ = apply(toks[:, :split], arange(0, split), cache,
                              "prefill")
    outs = [lp[:, -1]]
    for t in range(split, toks.shape[1]):
        lt, (_, cache), _ = apply(toks[:, t:t + 1], arange(t, t + 1), cache,
                                  "decode")
        outs.append(lt[:, 0])
    return outs, cache


def test_cached_decode_matches_jax_and_full_forward(jx):
    """A prefill of S - 2 through the self-attention rings, then 2 decode
    steps: within 1e-4 of the JAX cached decode, the rings equal, and
    within 2e-2 of the full forward (as ``tests/test_encdec.py``); each
    layer's cross K/V is computed at the prefill and read back after."""
    cfg, jcfg, params, jparams, toks, frames = _setup(jx)
    enc_out, _ = tencdec.encode(params, cfg, _t(frames))
    cache = init_encdec_cache(cfg, B, S, torch.float32, device="cpu")
    calls = []
    inner = tencdec.cross_kv

    def counted(*a):
        calls.append(1)
        return inner(*a)

    tencdec.cross_kv = counted
    try:
        outs, cache = _cached_decode(
            lambda t, pos, c, mode: encdec_apply(
                params, cfg, t, None, positions=pos, cache=c,
                enc_out=enc_out, mode=mode),
            enc_out, _t(toks).long(), cache,
            lambda a, z: torch.arange(a, z), S - 2)
    finally:
        tencdec.cross_kv = inner
    assert len(calls) == cfg.num_layers  # the prefill only
    dec = torch.stack(outs, 1)

    japply = jx.jax.jit(
        lambda t, pos, c, e, mode: jx.encdec.encdec_apply(
            jparams, jcfg, t, None, positions=pos, cache=c, enc_out=e,
            mode=mode), static_argnames="mode")
    jenc, _ = jx.encdec.encode(jparams, jcfg, frames)
    jcache = jx.encdec.init_encdec_cache(jcfg, B, S, jx.jnp.float32)
    jouts, jcache = _cached_decode(
        lambda t, pos, c, mode: japply(t, pos, c, jenc, mode=mode),
        jenc, toks, jcache, lambda a, z: jx.jnp.arange(a, z), S - 2)
    close(dec, np.stack([np.asarray(o) for o in jouts], 1))
    for layer, jlayer in zip(cache, jcache):
        assert set(layer) == set(jlayer) == {"self", "cross_kv"}
        for k, v in layer["self"]["attn"].items():
            w = np.asarray(jlayer["self"]["attn"][k])
            if k == "pos":
                np.testing.assert_array_equal(v.numpy(), w)
            else:
                close(v, w)
        for k in ("k", "v"):
            close(layer["cross_kv"][k], jlayer["cross_kv"][k])

    full = encdec_apply(params, cfg, _t(toks).long(), _t(frames))[0]
    ref = full[:, S - 3:]
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 2e-2, rel


def test_soft_moe_on_encoder(jx):
    """The paper's technique on the non-causal encoder: the softified
    config's loss and gradients finite and within 1e-4 of JAX."""
    cfg, jcfg, params, jparams, toks, frames = _setup(jx, soft=True)
    assert cfg.moe is not None and cfg.moe.variant == "soft"
    enc = tencdec._enc_cfg(cfg)
    assert enc.moe_layer_indices() and all(
        "moe" in params["enc_layers"][i] for i in enc.moe_layer_indices())
    batch = {"tokens": _t(toks).long(), "embeds": _t(frames)}
    loss, _, grads = _grads(params, cfg, batch)
    (jloss, _), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.encdec.encdec_loss(p, jcfg, b), has_aux=True))(
            jparams, {"tokens": toks, "embeds": frames})
    assert np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for g, w in zip(jx.jax.tree_util.tree_leaves(grads),
                    jx.jax.tree_util.tree_leaves(jgrads)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def test_chunked_cross_attention_matches_jax(jx, monkeypatch):
    """With ``_CHUNKED_THRESHOLD`` lowered in both packages the cross
    attention (and the self attention) take the chunked path, with zero
    positions and no mask: the logits stay within 1e-4 of JAX's, and of
    the dense path's."""
    cfg, jcfg, params, jparams, toks, frames = _setup(jx)
    dense = encdec_apply(params, cfg, _t(toks).long(), _t(frames))[0]
    monkeypatch.setattr(tattn, "_CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(tencdec, "_CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(jx.attn, "_CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(jx.encdec, "_CHUNKED_THRESHOLD", 16)
    seen = []
    inner = tencdec._attend_chunked
    monkeypatch.setattr(tencdec, "_attend_chunked",
                        lambda *a, **k: seen.append(1) or inner(*a, **k))
    chunked = encdec_apply(params, cfg, _t(toks).long(), _t(frames))[0]
    assert len(seen) == cfg.num_layers
    jlogits = jx.encdec.encdec_apply(jparams, jcfg, toks, frames)[0]
    close(chunked, jlogits)
    close(chunked, dense.numpy())


def _same(got, want):
    """Equal trees, key by key (dict order may differ)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert torch.equal(got, want)


def test_conversion_build_model_and_decoder_stack(jx):
    """``params_from_jax`` and ``train_state_from_jax`` on the enc-dec
    tree give back the port's params leaf for leaf; ``build_model`` is
    the enc-dec triple; ``lm_init``/``lm_apply`` take seamless as the
    reference does: the decoder stack with the audio frames' projection
    prepended."""
    cfg, jcfg, params, jparams, toks, frames = _setup(jx)
    tree = jx.jax.tree_util.tree_map(np.asarray, jparams)
    back = params_from_jax(tree, cfg, device="cpu")
    _same(back, params)
    state = train_state_from_jax({"params": tree, "opt": {
        "mu": tree, "nu": tree, "step": np.int32(3)}}, cfg, device="cpu")
    assert int(state["opt"]["step"]) == 3
    assert len(tree_leaves(state["opt"]["nu"])) == len(tree_leaves(params))

    init, loss_fn, apply_fn = build_model(cfg)
    p = init(torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(p), tree_leaves(params)):
        assert torch.equal(a, b)
    batch = {"tokens": _t(toks).long(), "embeds": _t(frames)}
    loss, metrics = loss_fn(p, batch)
    assert float(loss) == float(encdec_loss(params, cfg, batch)[0])
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 1.0
    logits, (enc_out, _), _ = apply_fn(p, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert enc_out.shape == (B, cfg.frontend.num_embeds, cfg.d_model)

    lp = lm_init(torch.Generator().manual_seed(0), cfg)
    assert len(lp["layers"]) == cfg.num_layers and "frontend" in lp
    out = lm_apply(lp, cfg, _t(toks).long(), embeds=_t(frames))[0]
    assert out.shape == (B, cfg.frontend.num_embeds + S, cfg.vocab_size)
    assert torch.isfinite(out).all()


def test_synthetic_seq2seq():
    """The JAX class's fields, shapes and dtypes; tokens within the
    vocabulary; a pure function of (seed, step, host)."""
    data = SyntheticSeq2Seq(vocab_size=50, seq_len=7, num_frames=5,
                            frame_dim=3, batch_size=4, num_hosts=2,
                            host_id=1, device="cpu")
    b = data.batch(2)
    assert set(b) == {"tokens", "embeds"}
    assert b["tokens"].shape == (2, 7) and b["tokens"].dtype == torch.int32
    assert b["embeds"].shape == (2, 5, 3)
    assert b["embeds"].dtype == torch.float32
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < 50
    again = data.batch(2)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["embeds"], data.batch(3)["embeds"])
    big = SyntheticSeq2Seq(vocab_size=50, seq_len=4000, num_frames=1,
                           frame_dim=1, batch_size=1, device="cpu")
    assert len(torch.unique(big.batch(0)["tokens"])) == 50
