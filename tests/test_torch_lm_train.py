"""The port's Soft-MoE LM training path against the JAX package, on
reduced ``granite-moe-1b-a400m+soft`` (4 layers, the last two Soft MoE)
in f32.

- ``lm_apply(telemetry=True)``: the logits and the whole telemetry tree,
  in the unrolled structure (``reduced``'s default: one key per layer)
  and in the scan structure (``scan_layers=True, remat=True``: one key
  per segment, leaves stacked (count,)), on the einsum and the kernel
  path (the JAX kernels in interpret mode, the port's plain versions):
  atol and rtol 1e-4 (four layers of f32 sums in other orders).
- ``lm_loss`` and its gradients against ``jax.grad`` in the same four
  settings: the loss within rtol 1e-5; every leaf within 1e-4 of its
  largest JAX value, plus 1e-4 relative.
- The routing-health kernel runs once per MoE layer per step under remat
  (the recompute takes no telemetry), and telemetry leaves the loss the
  same bitwise.
- ``SyntheticLM``'s transition table is the JAX stream's, and every
  token follows it; ``flatten_telemetry`` gives the JAX names and values
  on the same tree (both structures); a 3-step ``Trainer`` run logs the
  JAX Trainer's ``telemetry_*`` keys; microbatch aggregation takes the
  max of ``max_*`` telemetry leaves and the mean of the rest; the LM
  train state converts through ``convert.py``.

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
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import lm_apply, lm_loss
from repro_torch.optim import OptimizerConfig, tree_leaves
from repro_torch.serve.telemetry import flatten_telemetry, telemetry_rows
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train.step import _aggregate

ARCH = "granite-moe-1b-a400m+soft"
# (use_kernel, scan_layers + remat)
PATHS = [(False, False), (True, False), (False, True), (True, True)]
PATH_IDS = ["einsum-unrolled", "kernel-unrolled", "einsum-scan-remat",
            "kernel-scan-remat"]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.models.lm import lm_apply as jlm_apply
    from repro.models.lm import lm_init as jlm_init
    from repro.models.lm import lm_loss as jlm_loss
    from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
    from repro.serve.telemetry import flatten_telemetry as jflatten
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig

    cfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="float32")
    params = jlm_init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, params=params, tokens=tokens,
        apply=jlm_apply, loss=jlm_loss, init=jlm_init,
        SyntheticLM=JSyntheticLM, flatten=jflatten, Trainer=JTrainer,
        TrainerConfig=JTrainerConfig, OptimizerConfig=JOptimizerConfig)


def _cfgs(jx, scan):
    kw = dict(scan_layers=scan, remat=scan)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32",
                              **kw)
    jcfg = dataclasses.replace(jx.cfg, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _params(jx, cfg):
    return params_from_jax(_np_tree(jx, jx.params), cfg, device="cpu")


def _tree_close(got, want, atol, rtol, path="telemetry"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], atol, rtol, f"{path}.{k}")
        return
    got = got.detach().float().numpy()
    assert got.shape == np.shape(want), path
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=path)


@pytest.mark.parametrize("use_kernel,scan", PATHS, ids=PATH_IDS)
def test_lm_apply_logits_and_telemetry_match_jax(jx, use_kernel, scan):
    cfg, jcfg = _cfgs(jx, scan)
    jlogits, _, jaux, jtelem = jx.apply(
        jx.params, jcfg, jx.jnp.asarray(jx.tokens), mode="train",
        use_kernel=use_kernel, telemetry=True)
    logits, _, aux, telem = lm_apply(
        _params(jx, cfg), cfg, torch.from_numpy(jx.tokens).long(),
        mode="train", use_kernel=use_kernel, telemetry=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert float(aux) == float(jaux) == 0.0
    jtelem = _np_tree(jx, jtelem)
    # the structure: one key per layer unrolled, one per segment scanned
    want_keys = [0, 2] if scan else [0, 1, 2, 3]
    assert sorted(jtelem["layers"]) == want_keys
    if scan:
        assert np.shape(jtelem["layers"][2]["moe"]["rows"]
                        ["dispatch_entropy"]) == (2, 2)
    _tree_close(telem, jtelem, 1e-4, 1e-4)


@pytest.mark.parametrize("use_kernel,scan", PATHS, ids=PATH_IDS)
def test_lm_loss_and_grads_match_jax(jx, use_kernel, scan):
    cfg, jcfg = _cfgs(jx, scan)
    batch = {"tokens": jx.jnp.asarray(jx.tokens)}
    (jl, jm), jgrads = jx.jax.value_and_grad(
        lambda p: jx.loss(p, jcfg, batch, use_kernel=use_kernel,
                          telemetry=True), has_aux=True)(jx.params)
    params = _params(jx, cfg)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = lm_loss(params, cfg,
                            {"tokens": torch.from_numpy(jx.tokens)},
                            use_kernel=use_kernel, telemetry=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"].detach()),
                               float(jm["loss"]), rtol=1e-5)
    _tree_close(metrics["telemetry"], _np_tree(jx, jm["telemetry"]), 1e-4,
                1e-4)
    want = tree_leaves(params_from_jax(_np_tree(jx, jgrads), cfg,
                                       device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        top = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * top)


def test_lm_loss_mask_matches_jax(jx):
    cfg, jcfg = _cfgs(jx, False)
    mask = np.ones_like(jx.tokens)
    mask[0, 10:] = 0
    jl, _ = jx.loss(jx.params, jcfg, {"tokens": jx.jnp.asarray(jx.tokens),
                                      "loss_mask": jx.jnp.asarray(mask)})
    loss, _ = lm_loss(_params(jx, cfg), cfg,
                      {"tokens": torch.from_numpy(jx.tokens),
                       "loss_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def test_remat_runs_routing_health_once_per_moe_layer(monkeypatch, jx):
    """K6 runs in the forward only: the remat recompute takes no
    telemetry, and the flag leaves the loss and gradients bitwise the
    same."""
    cfg, _ = _cfgs(jx, True)
    params = _params(jx, cfg)
    calls = []
    real = ops.routing_health

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "routing_health", counted)
    batch = {"tokens": torch.from_numpy(jx.tokens)}
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    out = {}
    for telemetry in (False, True):
        loss, _ = lm_loss(params, cfg, batch, use_kernel=True,
                          telemetry=telemetry)
        out[telemetry] = (loss, torch.autograd.grad(loss, leaves))
    assert len(calls) == len(cfg.moe_layer_indices()) == 2
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))


def test_synthetic_lm_follows_the_jax_table(jx):
    kw = dict(vocab_size=300, seq_len=24, batch_size=4, seed=3)
    data = SyntheticLM(device="cpu", **kw)
    jdata = jx.SyntheticLM(**kw)
    np.testing.assert_array_equal(data._next, jdata._next)
    b = data.batch(5)["tokens"]
    assert b.dtype == torch.int32 and tuple(b.shape) == (4, 24)
    assert int(b.min()) >= 0 and int(b.max()) < 300
    table = torch.from_numpy(jdata._next)
    for row in b.long():
        for t in range(1, row.shape[0]):
            assert int(row[t]) in table[row[t - 1]].tolist()
    jb = np.asarray(jdata.batch(5)["tokens"])
    assert jb.dtype == np.int32 and jb.shape == (4, 24)
    # a pure function of (seed, step): a restarted stream repeats itself
    assert torch.equal(SyntheticLM(device="cpu", **kw).batch(5)["tokens"], b)
    assert not torch.equal(data.batch(6)["tokens"], b)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_flatten_telemetry_matches_jax(jx, scan):
    _, jcfg = _cfgs(jx, scan)
    jtelem = _np_tree(jx, jx.apply(
        jx.params, jcfg, jx.jnp.asarray(jx.tokens), mode="train",
        telemetry=True)[3])
    want = jx.flatten(jtelem)
    torch_tree = jx.jax.tree_util.tree_map(torch.from_numpy, jtelem)
    got = flatten_telemetry(torch_tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
    assert flatten_telemetry(jtelem) == got  # numpy leaves too
    assert "logits_nonfinite_count_val" in got
    rows = telemetry_rows(torch_tree)
    assert sorted(k for k in rows if k != "logits") == ([2] if scan
                                                        else [2, 3])


def test_train_step_aggregates_telemetry_over_microbatches():
    a = {"layers": {0: {"max_attn_out": torch.tensor([1.0, 5.0]),
                        "moe": {"dispatch_entropy": torch.tensor([2.0, 4.0]),
                                "rows": {"combine_entropy": torch.ones(2)}}}},
         "logits": {"max_abs_logit": torch.tensor([3.0, 1.0])}}
    b = {"layers": {0: {"max_attn_out": torch.tensor([2.0, 0.0]),
                        "moe": {"dispatch_entropy": torch.tensor([4.0, 0.0]),
                                "rows": {"combine_entropy": torch.zeros(2)}}}},
         "logits": {"max_abs_logit": torch.tensor([0.0, 7.0])}}
    out = _aggregate([a, b])
    assert out["layers"][0]["max_attn_out"].tolist() == [2.0, 5.0]
    assert out["layers"][0]["moe"]["dispatch_entropy"].tolist() == [3.0, 2.0]
    assert out["layers"][0]["moe"]["rows"]["combine_entropy"].tolist() == [
        0.5, 0.5]
    assert out["logits"]["max_abs_logit"].tolist() == [3.0, 7.0]


def test_trainer_logs_the_jax_telemetry_keys(jx, tmp_path):
    """Three steps of each package's Trainer on the telemetry loss (the
    port's on the kernel path, JAX's on the einsum path: the keys do not
    depend on it) log the same ``telemetry_*`` names."""
    cfg, jcfg = _cfgs(jx, True)
    data_kw = dict(vocab_size=cfg.vocab_size, seq_len=12, batch_size=2)
    tc = dict(total_steps=3, checkpoint_every=100, log_every=1)
    trainer = Trainer(
        TrainerConfig(checkpoint_dir=str(tmp_path / "port"), microbatches=2,
                      **tc),
        lambda p, b: lm_loss(p, cfg, b, use_kernel=True, telemetry=True),
        None, OptimizerConfig(total_steps=3, warmup_steps=1),
        SyntheticLM(device="cpu", **data_kw))
    start = {"params": _params(jx, cfg)}
    from repro_torch.optim import adamw_init

    start["opt"] = adamw_init(start["params"])
    trainer.run(torch.Generator().manual_seed(0), start_state=start)
    jtrainer = jx.Trainer(
        jx.TrainerConfig(checkpoint_dir=str(tmp_path / "jax"), **tc),
        lambda p, b: jx.loss(p, jcfg, b, telemetry=True),
        lambda r: jx.init(r, jcfg),
        jx.OptimizerConfig(total_steps=3, warmup_steps=1),
        jx.SyntheticLM(**data_kw))
    jtrainer.run(jx.jax.random.PRNGKey(0))
    assert len(trainer.metrics_history) == len(jtrainer.metrics_history) == 3
    for m, jm in zip(trainer.metrics_history, jtrainer.metrics_history):
        keys = sorted(k for k in m if k.startswith("telemetry_"))
        assert keys == sorted(k for k in jm if k.startswith("telemetry_"))
        assert "telemetry_moe_l2_token_contribution_min" in keys
        assert all(np.isfinite(m[k]) for k in keys)


def _tree_equal(got, want, j):
    """got (the port's layer j) equals want (a JAX segment) at index j."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_equal(got[k], want[k], j)
    else:
        np.testing.assert_array_equal(got.numpy(), want[j])


def test_lm_train_state_converts(jx):
    cfg, jcfg = _cfgs(jx, True)
    params = _np_tree(jx, jx.params)
    assert len(params["segments"]) == 2  # a dense and a Soft-MoE segment
    zeros = jx.jax.tree_util.tree_map(np.zeros_like, params)
    state = train_state_from_jax(
        {"params": params, "opt": {"mu": params, "nu": zeros,
                                   "step": np.int32(4)}}, cfg, device="cpu")
    assert int(state["opt"]["step"]) == 4
    for i, (start, count) in enumerate(((0, 2), (2, 2))):
        seg = params["segments"][i]
        for j in range(count):
            layer = state["params"]["layers"][start + j]
            assert ("moe" in layer) == (start >= 2)
            _tree_equal(layer, seg, j)
    assert all(not t.any() for t in tree_leaves(state["opt"]["nu"]))
    step = make_train_step(lambda p, b: lm_loss(p, cfg, b),
                           OptimizerConfig(total_steps=3))
    state, metrics = step(state, {"tokens": torch.from_numpy(jx.tokens)})
    assert np.isfinite(float(metrics["total_loss"]))
