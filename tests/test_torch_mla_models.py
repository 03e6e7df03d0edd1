"""The port's MLA and vlm models against the JAX package, in f32:

- reduced ``deepseek-v2-lite-16b`` (MLA; 4 layers, the last two Tokens
  Choice with a shared expert) and reduced ``pixtral-12b`` (GQA with the
  vision frontend stub, fed 8 patch embeddings): ``lm_apply`` logits, and
  ``lm_loss`` (pixtral scoring the text only) with its gradients against
  ``jax.grad``, unrolled and in the scan/remat structure; atol and rtol
  1e-4 (four layers of f32 sums in other orders), the loss within rtol
  1e-5;
- deepseek on the chunked attention path (``_CHUNKED_THRESHOLD`` lowered
  in both packages): loss and gradients, as above;
- ``params_from_jax`` carries both trees whole, the frontend included;
  ``lm_init`` draws the frontend only for a config that has one;
  ``build_model``'s apply passes the batch's embeds.

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
from repro_torch.layers import attention as tattn
from repro_torch.models import build_model, lm_apply, lm_init, lm_loss
from repro_torch.optim import tree_leaves, tree_map

ARCHS = ["deepseek-v2-lite-16b", "pixtral-12b"]
TOL = 1e-4
STRUCTURES = pytest.mark.parametrize("scan", [False, True],
                                     ids=["unrolled", "scan-remat"])


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.layers import attention as jattn
    from repro.models.lm import lm_apply as jlm_apply
    from repro.models.lm import lm_init as jlm_init
    from repro.models.lm import lm_loss as jlm_loss

    params, inputs = {}, {}
    for i, name in enumerate(ARCHS):
        cfg = dataclasses.replace(jreduced(jget_config(name)),
                                  dtype="float32")
        params[name] = _jax_tree(
            jax, jlm_init, lm_init(torch.Generator().manual_seed(i),
                                   reduced(get_config(name))), cfg)
        rng = np.random.RandomState(i)
        batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                       (2, 16)).astype(np.int32)}
        if cfg.frontend.kind != "none":
            batch["embeds"] = rng.randn(
                2, cfg.frontend.num_embeds,
                cfg.frontend.embed_dim).astype(np.float32)
        inputs[name] = batch
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, attn=jattn, get_config=jget_config,
        reduced=jreduced, params=params, inputs=inputs, apply=jlm_apply,
        loss=jlm_loss)


def _jax_tree(jax, jlm_init, params, jcfg):
    """The port's params in the JAX package's layout (each segment's
    layers stacked on a leading axis), checked leaf for leaf against the
    tree that the JAX ``lm_init`` makes (``jax.eval_shape``, no draws:
    drawing the reference's weights on the CPU costs seconds a model)."""
    from repro_torch.models import segment_plan

    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["segments"] = [
        tree_map(lambda *ts: np.stack([t.numpy() for t in ts]),
                 *params["layers"][start:start + count])
        for start, count, _ in segment_plan(jcfg)]
    want = jax.eval_shape(lambda k: jlm_init(k, jcfg), jax.random.PRNGKey(0))
    got_leaves, got_def = jax.tree_util.tree_flatten(tree)
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    assert got_def == want_def
    assert [(a.shape, a.dtype) for a in got_leaves] == \
        [(a.shape, a.dtype) for a in want_leaves]
    return tree


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(jx, name, scan):
    kw = dict(scan_layers=scan, remat=scan, dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(name)), **kw)
    jcfg = dataclasses.replace(jx.reduced(jx.get_config(name)), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _batches(jx, name):
    """(JAX batch, torch batch) of the same numpy inputs."""
    b = jx.inputs[name]
    return ({k: jx.jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _leaves_close(got, want):
    """Leaf by leaf: |got - want| <= TOL max|want| + TOL |want|."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * float(w.abs().max()))


@pytest.mark.parametrize("name", ARCHS)
@STRUCTURES
def test_logits_match_jax(jx, name, scan):
    cfg, jcfg = _cfgs(jx, name, scan)
    jb, tb = _batches(jx, name)
    jlogits, _, jaux = jx.jax.jit(lambda p, b: jx.apply(
        p, jcfg, b["tokens"], embeds=b.get("embeds"), mode="train"))(
            jx.params[name], jb)
    params = params_from_jax(_np_tree(jx, jx.params[name]), cfg,
                             device="cpu")
    with torch.no_grad():
        logits, _, aux = lm_apply(params, cfg, tb["tokens"].long(),
                                  embeds=tb.get("embeds"), mode="train")
    n_prefix = cfg.frontend.num_embeds if "embeds" in tb else 0
    assert logits.shape == (2, n_prefix + 16, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)


def _loss_and_grads(jx, name, cfg, jcfg):
    jb, tb = _batches(jx, name)
    (jl, jm), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.loss(p, jcfg, b), has_aux=True))(jx.params[name], jb)
    params = params_from_jax(_np_tree(jx, jx.params[name]), cfg,
                             device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = lm_loss(params, cfg, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7)
    want = params_from_jax(_np_tree(jx, jgrads), cfg, device="cpu")
    _leaves_close(list(grads), want)
    return params, leaves, grads


@pytest.mark.parametrize("name", ARCHS)
@STRUCTURES
def test_loss_and_grads_match_jax(jx, name, scan):
    """pixtral's loss scores the 16 text tokens only, and its frontend
    projection takes a gradient through the prepended patches."""
    cfg, jcfg = _cfgs(jx, name, scan)
    params, leaves, grads = _loss_and_grads(jx, name, cfg, jcfg)
    if "frontend" in params:
        (g,) = [g for t, g in zip(leaves, grads)
                if t is params["frontend"]["w"]]
        assert g.abs().max() > 0


def test_deepseek_on_the_chunked_path_matches_jax(jx, monkeypatch):
    """With the threshold lowered in both packages below 18 queries x 18
    keys, every MLA layer attends through the chunked path (its 18 keys
    padded to one 1024-key block) in the forward and the remat backward."""
    name = ARCHS[0]
    monkeypatch.setattr(jx.attn, "_CHUNKED_THRESHOLD", 16 * 16)
    monkeypatch.setattr(tattn, "_CHUNKED_THRESHOLD", 16 * 16)
    calls = []
    inner = tattn._attend_chunked
    monkeypatch.setattr(tattn, "_attend_chunked",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    jx.inputs["chunked"] = {"tokens": np.random.RandomState(9).randint(
        0, 256, (2, 18)).astype(np.int32)}
    jx.params["chunked"] = jx.params[name]
    try:
        cfg, jcfg = _cfgs(jx, name, True)
        _loss_and_grads(jx, "chunked", cfg, jcfg)
    finally:
        del jx.inputs["chunked"], jx.params["chunked"]
    # 4 layers in the forward, again in the remat recompute
    assert len(calls) == 2 * cfg.num_layers


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_carries_the_whole_tree(jx, name):
    """The JAX layout of the port's own ``lm_init`` params (checked against
    the JAX ``lm_init``'s tree in the fixture) converts back to exactly
    those params, the frontend included."""
    cfg, _ = _cfgs(jx, name, False)
    mine = lm_init(torch.Generator().manual_seed(ARCHS.index(name)),
                   reduced(get_config(name)))
    params = params_from_jax(jx.params[name], cfg, device="cpu")
    assert set(params) == set(mine)
    assert ("frontend" in params) == (cfg.frontend.kind != "none")
    for k in mine:
        got, want = tree_leaves(params[k]), tree_leaves(mine[k])
        assert len(got) == len(want), k
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k


def test_frontend_drawn_only_with_a_frontend():
    """A config without a frontend draws nothing for it, so the seeded
    weights of the archs ported before it keep their values; pixtral
    draws its projection right after the embedding."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    pix = reduced(get_config("pixtral-12b"))
    plain = dataclasses.replace(pix, frontend=get_config(
        "qwen2-0.5b").frontend)
    with_fe, without = lm_init(gen(), pix), lm_init(gen(), plain)
    assert "frontend" not in without
    assert with_fe["frontend"]["w"].shape == (pix.frontend.embed_dim,
                                              pix.d_model)
    assert torch.equal(with_fe["embed"]["table"], without["embed"]["table"])


def test_build_model_apply_passes_embeds():
    cfg = dataclasses.replace(reduced(get_config("pixtral-12b")),
                              dtype="float32")
    init, loss_fn, apply = build_model(cfg)
    params = init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {"tokens": torch.from_numpy(rng.randint(0, 256, (2, 5))),
             "embeds": torch.from_numpy(rng.randn(
                 2, cfg.frontend.num_embeds,
                 cfg.frontend.embed_dim).astype(np.float32))}
    with torch.no_grad():
        logits = apply(params, batch)[0]
        want = lm_apply(params, cfg, batch["tokens"],
                        embeds=batch["embeds"])[0]
        text = lm_apply(params, cfg, batch["tokens"])[0]
        loss = loss_fn(params, batch)[1]["loss"]
    assert logits.shape == (2, cfg.frontend.num_embeds + 5, cfg.vocab_size)
    assert torch.equal(logits, want)
    assert text.shape == (2, 5, cfg.vocab_size)
    assert torch.isfinite(loss)
