"""The port's sparse-MoE models against the JAX package, in f32:

- reduced ``granite-moe-1b-a400m`` as configured (Tokens Choice, top-2
  of 4 after ``reduced``, capacity factor 1.0, no BPR, groups of one
  sequence; 4 layers, the last two MoE): ``lm_apply`` logits, aux loss
  and the whole telemetry tree (Tokens Choice's ``rows`` included),
  ``lm_loss`` (loss + aux) and its gradients against ``jax.grad``,
  unrolled and in the scan/remat structure (one key per segment, leaves
  stacked (count,)); atol and rtol 1e-4 (four layers of f32 sums in
  other orders), the loss within rtol 1e-5;
- one ``make_train_step`` step from the same converted state: the
  metrics within rtol 1e-4 and the new params and moments within 1e-4 of
  their largest JAX value;
- reduced ``soft_moe_vit("s", 32, 8, variant=v)`` for each sparse and
  ablation variant: logits (a non-zero head drawn here) and pre-head
  features within atol and rtol 1e-4.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced, soft_moe_vit
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.models import lm_apply, lm_loss, vit_apply, vit_features
from repro_torch.optim import OptimizerConfig, tree_leaves
from repro_torch.train import make_train_step

ARCH = "granite-moe-1b-a400m"
TOL = 1e-4
VIT_VARIANTS = ["tokens_choice", "experts_choice", "identity", "uniform",
                "soft_uniform", "uniform_soft"]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.configs import soft_moe_vit as jsoft_moe_vit
    from repro.models.lm import lm_apply as jlm_apply
    from repro.models.lm import lm_init as jlm_init
    from repro.models.lm import lm_loss as jlm_loss
    from repro.models.vit import vit_apply as jvit_apply
    from repro.models.vit import vit_features as jvit_features
    from repro.models.vit import vit_init as jvit_init
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    cfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="float32")
    params = jlm_init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, params=params, tokens=tokens,
        apply=jlm_apply, loss=jlm_loss, adamw=jadamw, step=jstep,
        reduced=jreduced, soft_moe_vit=jsoft_moe_vit, vit_init=jvit_init,
        vit_apply=jvit_apply, vit_features=jvit_features)


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(jx, scan):
    kw = dict(scan_layers=scan, remat=scan)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32",
                              **kw)
    jcfg = dataclasses.replace(jx.cfg, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.moe.variant, cfg.moe.bpr, cfg.moe.group_size,
            cfg.moe.capacity_factor) == ("tokens_choice", False, 1, 1.0)
    return cfg, jcfg


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


def _leaves_close(got, want):
    """Leaf by leaf: |got - want| <= TOL max|want| + TOL |want|."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float(), w.detach().float()
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * float(w.abs().max()))


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled",
                                                    "scan-remat"])
def test_granite_logits_aux_and_telemetry_match_jax(jx, scan):
    cfg, jcfg = _cfgs(jx, scan)
    jlogits, _, jaux, jtelem = jx.apply(
        jx.params, jcfg, jx.jnp.asarray(jx.tokens), mode="train",
        telemetry=True)
    logits, _, aux, telem = lm_apply(
        params_from_jax(_np_tree(jx, jx.params), cfg, device="cpu"), cfg,
        torch.from_numpy(jx.tokens).long(), mode="train", telemetry=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0  # the balance and z losses of two MoE layers
    jtelem = _np_tree(jx, jtelem)
    assert sorted(jtelem["layers"]) == ([0, 2] if scan else [0, 1, 2, 3])
    moe = jtelem["layers"][2]["moe"]
    assert {"router_entropy", "max_router_prob", "expert_load_spread",
            "kept_fraction", "dropped_fraction", "rows"} <= set(moe)
    if scan:
        assert np.shape(moe["rows"]["router_entropy"]) == (2, 2)
    _tree_close(telem, jtelem)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled",
                                                    "scan-remat"])
def test_granite_loss_and_grads_match_jax(jx, scan):
    cfg, jcfg = _cfgs(jx, scan)
    batch = {"tokens": jx.jnp.asarray(jx.tokens)}
    (jl, jm), jgrads = jx.jax.value_and_grad(
        lambda p: jx.loss(p, jcfg, batch, telemetry=True),
        has_aux=True)(jx.params)
    params = params_from_jax(_np_tree(jx, jx.params), cfg, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = lm_loss(params, cfg,
                            {"tokens": torch.from_numpy(jx.tokens)},
                            telemetry=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5)
    _tree_close(metrics["telemetry"], _np_tree(jx, jm["telemetry"]))
    want = tree_leaves(params_from_jax(_np_tree(jx, jgrads), cfg,
                                       device="cpu"))
    assert len(grads) == len(want)
    _leaves_close(list(grads), want)
    # the router of each MoE layer takes a gradient (balance + z losses)
    for i in cfg.moe_layer_indices():
        router = params["layers"][i]["moe"]["router"]
        (g,) = [g for t, g in zip(leaves, grads) if t is router]
        assert g.abs().max() > 0


def test_granite_train_step_matches_jax(jx):
    cfg, jcfg = _cfgs(jx, True)
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10)
    jocfg = jx.adamw.OptimizerConfig(**dataclasses.asdict(ocfg))
    jstate = {"params": jx.params, "opt": jx.adamw.adamw_init(jx.params)}
    state = train_state_from_jax(_np_tree(jx, jstate), cfg, device="cpu")
    jstep = jx.jax.jit(jx.step.make_train_step(
        lambda p, b: jx.loss(p, jcfg, b), jocfg))
    step = make_train_step(lambda p, b: lm_loss(p, cfg, b), ocfg)
    jstate, jm = jstep(jstate, {"tokens": jx.jnp.asarray(jx.tokens)})
    state, m = step(state, {"tokens": torch.from_numpy(jx.tokens)})
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                   atol=1e-6, err_msg=k)
    want = train_state_from_jax(_np_tree(jx, jstate), cfg, device="cpu")
    _leaves_close(state["params"], want["params"])
    for part in ("mu", "nu"):
        _leaves_close(state["opt"][part], want["opt"][part])


@pytest.mark.parametrize("variant", VIT_VARIANTS)
def test_sparse_and_ablation_vit_match_jax(jx, variant):
    jcfg = dataclasses.replace(
        jx.reduced(jx.soft_moe_vit("s", 32, 8, variant=variant)),
        dtype="float32")
    cfg = dataclasses.replace(
        reduced(soft_moe_vit("s", 32, 8, variant=variant)), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.RandomState(1)
    jparams = jx.vit_init(jx.jax.random.PRNGKey(0), jcfg, num_classes=10)
    jparams = dict(jparams, head={
        "w": jx.jnp.asarray(rng.randn(cfg.d_model, 10).astype(np.float32)),
        "b": jx.jnp.asarray(rng.randn(10).astype(np.float32))})
    patches = rng.randn(3, cfg.frontend.num_embeds,
                        cfg.frontend.embed_dim).astype(np.float32)
    params = params_from_jax(_np_tree(jx, jparams), cfg, device="cpu")
    jlogits, jaux = jx.vit_apply(jparams, jcfg, jx.jnp.asarray(patches))
    with torch.no_grad():
        logits, aux = vit_apply(params, cfg, torch.from_numpy(patches))
        feats = vit_features(params, cfg, torch.from_numpy(patches))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        feats.numpy(),
        np.asarray(jx.vit_features(jparams, jcfg, jx.jnp.asarray(patches))),
        atol=TOL, rtol=TOL)
