"""The port's SSM and hybrid LMs against the JAX package, in f32:

- reduced ``mamba2-370m`` (attention-free Mamba-2 blocks, no MLP) and
  reduced ``hymba-1.5b`` (attention and Mamba-2 in parallel, mean-fused,
  with a gated MLP) with ``global_every=2``, so that its sliding-window
  layers (window 16) and its global ones both run over 24 tokens:
  ``lm_apply`` logits with the whole telemetry tree (no ``max_attn_out``
  on mamba2), and ``lm_loss`` with its gradients against ``jax.grad``,
  unrolled and in the scan/remat structure; atol and rtol 1e-4, the loss
  within rtol 1e-5. The gradients are held against the JAX package's
  evaluated in f64 (``jax.enable_x64``, its SSM's f32 casts lifted to
  f64): in f32 the reference forms the SSD decays from differences of
  one cumulative sum, which cancel, and its f32 ``A_log`` gradient on
  reduced mamba2 carries more rounding than this bound; the port forms
  the decays in f64;
- ``params_from_jax`` and ``train_state_from_jax`` carry the ``ssm``
  subtree whole, and ``build_model`` gives init, loss and apply for both
  archs.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import build_model, lm_apply, lm_init, lm_loss
from repro_torch.models import segment_plan
from repro_torch.optim import tree_leaves, tree_map

ARCHS = ["mamba2-370m", "hymba-1.5b"]
TOL = 1e-4
STRUCTURES = pytest.mark.parametrize("scan", [False, True],
                                     ids=["unrolled", "scan-remat"])


def _reduced(get, red, name, **kw):
    """The reduced config; hymba's with a global layer every second one
    (reduced hymba's ``global_every=16`` over 4 layers has none)."""
    cfg = dataclasses.replace(red(get(name)), dtype="float32", **kw)
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
    from repro.layers import ssm as jssm
    from repro.models.lm import lm_apply as jlm_apply
    from repro.models.lm import lm_init as jlm_init
    from repro.models.lm import lm_loss as jlm_loss

    params, tokens = {}, {}
    for i, name in enumerate(ARCHS):
        jcfg = _reduced(jget_config, jreduced, name)
        params[name] = _jax_tree(jax, jlm_init, _mine(name), jcfg)
        tokens[name] = np.random.RandomState(i).randint(
            0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ssm=jssm, get_config=jget_config,
        reduced=jreduced, params=params, tokens=tokens, apply=jlm_apply,
        loss=jlm_loss)


def _mine(name):
    return lm_init(torch.Generator().manual_seed(ARCHS.index(name)),
                   _reduced(get_config, reduced, name))


def _jax_tree(jax, jlm_init, params, jcfg):
    """The port's params in the JAX package's layout (each segment's
    layers stacked on a leading axis), checked leaf for leaf against the
    tree that the JAX ``lm_init`` makes (``jax.eval_shape``: no draws)."""
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


def _cfgs(jx, name, scan):
    kw = dict(scan_layers=scan, remat=scan)
    cfg = _reduced(get_config, reduced, name, **kw)
    jcfg = _reduced(jx.get_config, jx.reduced, name, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _params(jx, name, cfg):
    return params_from_jax(_np_tree(jx, jx.params[name]), cfg, device="cpu")


def _tree_close(got, want, path="telemetry"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], f"{path}.{k}")
        return
    got = got.detach().float().numpy()
    assert got.shape == np.shape(want), path
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=path)


@pytest.mark.parametrize("name", ARCHS)
def test_logits_and_telemetry_match_jax(jx, name):
    cfg, jcfg = _cfgs(jx, name, False)
    jlogits, _, _, jtelem = jx.jax.jit(lambda p, t: jx.apply(
        p, jcfg, t, mode="train", telemetry=True))(jx.params[name],
                                                   jx.tokens[name])
    params = _params(jx, name, cfg)
    with torch.no_grad():
        logits, _, _, telem = lm_apply(
            params, cfg, torch.from_numpy(jx.tokens[name]).long(),
            mode="train", telemetry=True)
    assert logits.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    _tree_close(telem, _np_tree(jx, jtelem))
    assert ("max_attn_out" in telem["layers"][0]) == cfg.has_attention()


def _jax_grads_f64(jx, name, jcfg, monkeypatch):
    """``jax.grad`` of the JAX ``lm_loss`` in f64: x64 on for the call and
    the SSM module's ``jnp.float32`` read as float64."""
    jnp = jx.jnp
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    f64.float32 = jnp.float64
    cfg64 = dataclasses.replace(jcfg, dtype="float64")
    with jx.jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jx.ssm, "jnp", f64)
        params = jx.jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            jx.params[name])
        grads = jx.jax.jit(jx.jax.grad(lambda p, t: jx.loss(
            p, cfg64, {"tokens": t})[0]))(params, jx.tokens[name])
        return jx.jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), grads)


@pytest.mark.parametrize("name", ARCHS)
@STRUCTURES
def test_loss_and_grads_match_jax(jx, name, scan, monkeypatch):
    cfg, jcfg = _cfgs(jx, name, scan)
    tokens = jx.tokens[name]
    jl, _ = jx.jax.jit(lambda p, t: jx.loss(p, jcfg, {"tokens": t}))(
        jx.params[name], tokens)
    jgrads = _jax_grads_f64(jx, name, jcfg, monkeypatch)
    params = _params(jx, name, cfg)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, _ = lm_loss(params, cfg, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = tree_leaves(params_from_jax(_np_tree(jx, jgrads), cfg,
                                       device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * float(w.abs().max()))
    ssm_grads = [g for t, g in zip(leaves, grads)
                 if any(t is v for v in params["layers"][0]["ssm"].values())]
    assert len(ssm_grads) == 12 and all(g.abs().max() > 0
                                        for g in ssm_grads)


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_and_build_model(jx, name):
    """The JAX layout of the port's params converts back to exactly those
    params, the ``ssm`` subtree included; ``build_model`` inits the same
    tree and its loss and apply run."""
    cfg, _ = _cfgs(jx, name, False)
    mine = _mine(name)
    params = params_from_jax(jx.params[name], cfg, device="cpu")
    assert set(params) == set(mine)
    assert set(params["layers"][0]) == set(mine["layers"][0])
    assert "ssm" in params["layers"][0]
    assert ("attn" in params["layers"][0]) == cfg.has_attention()
    assert ("norm2" in params["layers"][0]) == (cfg.d_ff > 0)
    for k in mine:
        got, want = tree_leaves(params[k]), tree_leaves(mine[k])
        assert len(got) == len(want), k
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k
    state = train_state_from_jax({"params": jx.params[name], "opt": {
        "mu": jx.params[name], "nu": jx.params[name], "step": np.int32(3)}},
        cfg, device="cpu")
    for k in ("mu", "nu"):
        got = state["opt"][k]["layers"][0]["ssm"]
        assert set(got) == set(mine["layers"][0]["ssm"])
        assert all(torch.equal(got[n], t)
                   for n, t in mine["layers"][0]["ssm"].items())
    assert int(state["opt"]["step"]) == 3
    init, loss_fn, apply = build_model(cfg)
    built = init(torch.Generator().manual_seed(ARCHS.index(name)))
    assert all(torch.equal(g, w) for g, w in
               zip(tree_leaves(built), tree_leaves(mine)))
    batch = {"tokens": torch.from_numpy(jx.tokens[name]).long()}
    with torch.no_grad():
        logits = apply(built, batch)[0]
        loss = loss_fn(built, batch)[1]["loss"]
    assert torch.equal(logits, lm_apply(built, cfg, batch["tokens"])[0])
    assert torch.isfinite(loss)
