"""The port's training stack against the JAX package, and its own
fault-tolerance contracts.

- ``vit_loss`` gradients of reduced ``soft_moe_vit("s", 32, 8)`` in f32,
  JAX-initialised with a random head (the zero head would make every
  backbone gradient zero), every leaf, on the einsum and the kernel path
  (the JAX kernels in interpret mode, the port's plain versions), with and
  without remat, against ``jax.grad`` of the JAX ``vit_loss``: each leaf
  within 1e-4 of its largest JAX value, plus 1e-4 relative (four layers
  of f32 sums in other orders).
- ``schedule_lr`` (all four schedules), ``clip_by_global_norm`` and three
  ``adamw_update`` steps on the same inputs against the JAX functions:
  f32, rtol 1e-6 and atol 1e-7 (the same ops in the same order; the
  libraries' ``pow``, ``sqrt`` and ``cos`` may differ by an ulp).
- Three ``make_train_step`` steps (build_model's loss, the einsum path),
  microbatches 1 and 2, from the same ``train_state_from_jax`` state on
  the same batches: the metrics within rtol 1e-4; params and moments
  within 1e-4 of each leaf's largest value, plus 1e-4 relative. Adam
  divides by sqrt(v) + eps, so where |g| is near eps a gradient that
  differs in its last bits moves the step by up to lr; the test measures
  leaves against their scale, not elementwise.
- Inside the port: an interrupted and resumed ``Trainer`` run equals an
  uninterrupted one bitwise; the ``CheckpointManager`` round trip is
  bitwise, bf16 leaves included, commits atomically and keeps N.
- ``SyntheticImages`` draws the JAX stream's readout, so its labels
  follow the JAX rule on the same patches.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced, soft_moe_vit
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import SyntheticImages
from repro_torch.models import build_model, vit_init, vit_loss
from repro_torch.optim import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    schedule_lr,
    tree_leaves,
)
from repro_torch.train import (
    StragglerWatchdog,
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
)

NUM_CLASSES = 10


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced as jreduced
    from repro.configs import soft_moe_vit as jsoft_moe_vit
    from repro.data import SyntheticImages as JSyntheticImages
    from repro.models.vit import vit_init as jvit_init
    from repro.models.vit import vit_loss as jvit_loss
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    cfg = dataclasses.replace(jreduced(jsoft_moe_vit("s", 32, 8)),
                              dtype="float32")
    params = jvit_init(jax.random.PRNGKey(0), cfg, num_classes=NUM_CLASSES)
    rng = np.random.RandomState(0)
    head = {"w": rng.randn(cfg.d_model, NUM_CLASSES).astype(np.float32) * 0.5,
            "b": rng.randn(NUM_CLASSES).astype(np.float32) * 0.1}
    params = dict(params, head={k: jnp.asarray(v) for k, v in head.items()})
    patches = rng.randn(4, cfg.frontend.num_embeds,
                        cfg.frontend.embed_dim).astype(np.float32)
    labels = np.array([1, 7, 3, 0], np.int32)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, params=params, patches=patches,
        labels=labels, loss=jvit_loss, adamw=jadamw, step=jstep,
        SyntheticImages=JSyntheticImages)


def _port_cfg(jx, **kw):
    cfg = dataclasses.replace(reduced(soft_moe_vit("s", 32, 8)),
                              dtype="float32", **kw)
    jcfg = dataclasses.replace(jx.cfg, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def _close_leaves(got, want, tol=1e-4):
    """Leaf by leaf: |got - want| <= tol max|want| + tol |want|."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float(), w.detach().float()
        assert g.shape == w.shape
        top = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                                   atol=tol * top)


@pytest.mark.parametrize("use_kernel,remat", [(False, False), (True, False),
                                              (True, True)])
def test_vit_loss_grads_match_jax(jx, use_kernel, remat):
    cfg, jcfg = _port_cfg(jx, remat=remat)
    batch = {"patches": jx.jnp.asarray(jx.patches),
             "labels": jx.jnp.asarray(jx.labels)}
    jgrads = jx.jax.grad(
        lambda p: jx.loss(p, jcfg, batch, use_kernel=use_kernel)[0])(
        jx.params)
    params = params_from_jax(_np_tree(jx, jx.params), cfg, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, _ = vit_loss(params, cfg, {"patches": torch.from_numpy(jx.patches),
                                     "labels": torch.from_numpy(jx.labels)},
                       use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, leaves)
    want = params_from_jax(_np_tree(jx, jgrads), cfg, device="cpu")
    wleaves = tree_leaves(want)
    # every backbone leaf has a gradient (the head is not zero)
    assert all(float(w.abs().max()) > 0 for w in wleaves
               if w.numel() > 1)
    _close_leaves(grads, wleaves)


@pytest.mark.parametrize("schedule", ["rsqrt", "cosine", "linear",
                                      "constant"])
def test_schedules_match_jax(jx, schedule):
    cfg = OptimizerConfig(peak_lr=3e-3, schedule=schedule, warmup_steps=20,
                          total_steps=300, cooldown_steps=30, timescale=100.0)
    jcfg = jx.adamw.OptimizerConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 7, 20, 21, 99, 150, 271, 299, 300, 450):
        got = schedule_lr(cfg, torch.tensor(step, dtype=torch.int32))
        want = jx.adamw.schedule_lr(jcfg, jx.jnp.asarray(step, jx.jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12)


def _opt_tree(seed):
    """A small params-like tree: nested dicts and a list of layers, keys
    in sorted order (JAX flattens dicts by sorted key, the port by
    insertion order)."""
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(5, 3).astype(np.float32),
            "layers": [{"s": np.float32(rng.randn()),
                        "w": rng.randn(4).astype(np.float32) * 3}
                       for _ in range(2)]}


def _jtree(jx, tree):
    return jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)


def _ttree(tree):
    if isinstance(tree, dict):
        return {k: _ttree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ttree(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(jx, max_norm):
    g = _opt_tree(1)
    jg, jnorm = jx.adamw.clip_by_global_norm(_jtree(jx, g), max_norm)
    tg = _ttree(g)
    out, norm = clip_by_global_norm(tg, max_norm)
    assert out is tg  # scaled in place
    _close(norm, jnorm)
    _close(global_norm(tg), jx.adamw.global_norm(jg))
    for a, b in zip(tree_leaves(out), jx.jax.tree_util.tree_leaves(jg)):
        _close(a, b)


def test_adamw_update_matches_jax_over_three_steps(jx):
    cfg = OptimizerConfig(peak_lr=3e-2, warmup_steps=2, timescale=2.0,
                          total_steps=10, cooldown_steps=3,
                          weight_decay=0.1, grad_clip_norm=2.0)
    jcfg = jx.adamw.OptimizerConfig(**dataclasses.asdict(cfg))
    params = _opt_tree(2)
    jp, tp = _jtree(jx, params), _ttree(params)
    jopt, topt = jx.adamw.adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = _opt_tree(10 + step)
        jp, jopt, jm = jx.adamw.adamw_update(_jtree(jx, g), jopt, jp, jcfg)
        tp2, topt, tm = adamw_update(_ttree(g), topt, tp, cfg)
        assert tp2 is tp  # updated in place
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        assert topt["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])
        for mine, theirs in ((tp, jp), (topt["mu"], jopt["mu"]),
                             (topt["nu"], jopt["nu"])):
            for a, b in zip(tree_leaves(mine),
                            jx.jax.tree_util.tree_leaves(theirs)):
                _close(a, b)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(jx, microbatches):
    cfg, jcfg = _port_cfg(jx)
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=2, schedule="rsqrt",
                           timescale=100.0, total_steps=300,
                           cooldown_steps=30)
    jocfg = jx.adamw.OptimizerConfig(**dataclasses.asdict(ocfg))
    jstate = {"params": jx.params, "opt": jx.adamw.adamw_init(jx.params)}
    state = train_state_from_jax(_np_tree(jx, jstate), cfg, device="cpu")
    jloss = lambda p, b: jx.loss(p, jcfg, b)  # noqa: E731 (build_model's)
    jstep = jx.jax.jit(jx.step.make_train_step(jloss, jocfg,
                                               microbatches=microbatches))
    step = make_train_step(build_model(cfg)[1], ocfg,
                           microbatches=microbatches)
    rng = np.random.RandomState(3)
    for _ in range(3):
        patches = rng.randn(4, cfg.frontend.num_embeds,
                            cfg.frontend.embed_dim).astype(np.float32)
        labels = rng.randint(0, NUM_CLASSES, size=4).astype(np.int32)
        jstate, jm = jstep(jstate, {"patches": jx.jnp.asarray(patches),
                                    "labels": jx.jnp.asarray(labels)})
        state, m = step(state, {"patches": torch.from_numpy(patches),
                                "labels": torch.from_numpy(labels)})
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6)
    want = train_state_from_jax(_np_tree(jx, jstate), cfg, device="cpu")
    assert int(state["opt"]["step"]) == int(want["opt"]["step"]) == 3
    for part in ("params", "mu", "nu"):
        got = state["params"] if part == "params" else state["opt"][part]
        ref = want["params"] if part == "params" else want["opt"][part]
        _close_leaves(got, ref)


def _tiny_vit():
    cfg = reduced(soft_moe_vit("s", 32, 8))
    return dataclasses.replace(cfg, dtype="float32")


class _Preempting:
    """SyntheticImages that raises the trainer's preemption flag (as its
    SIGTERM handler does) when the batch of ``at`` is drawn."""

    def __init__(self, data, trainer_ref, at):
        self.data, self.ref, self.at = data, trainer_ref, at

    def batch(self, step):
        if step == self.at:
            self.ref[0]._preempted = True
        return self.data.batch(step)


def test_trainer_resume_equals_uninterrupted_run_bitwise(tmp_path):
    cfg = _tiny_vit()
    init, loss_fn, _ = build_model(cfg)
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=6,
                           cooldown_steps=2, timescale=10.0)
    data = SyntheticImages(num_patches=cfg.frontend.num_embeds,
                           patch_dim=cfg.frontend.embed_dim, batch_size=4,
                           device="cpu")

    def trainer(d, feed=data):
        tcfg = TrainerConfig(total_steps=6, checkpoint_every=2,
                             checkpoint_dir=str(tmp_path / d), log_every=2)
        return Trainer(tcfg, loss_fn, init, ocfg, feed)

    whole = trainer("a").run(torch.Generator().manual_seed(0))
    ref = [None]
    first = trainer("b", _Preempting(data, ref, at=2))
    ref[0] = first
    cut = first.run(torch.Generator().manual_seed(0))
    assert int(cut["opt"]["step"]) == 3  # stopped after the step of batch 2
    resumed = trainer("b")
    assert resumed.ckpt.latest_step() == 3
    final = resumed.run(torch.Generator().manual_seed(0))
    assert int(final["opt"]["step"]) == 6
    for a, b in zip(tree_leaves(final), tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and the final checkpoints hold the same state
    for d in ("a", "b"):
        mgr = CheckpointManager(str(tmp_path / d))
        assert mgr.latest_step() == 6
        back = mgr.restore(6, whole)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(back), tree_leaves(whole)))
    # the resumed run took steps 3-5 and logged at steps 4 and 6
    assert [m["step"] for m in resumed.metrics_history] == [4, 6]


def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "h": torch.randn(5, generator=g).to(torch.bfloat16),
                       "layers": [{"b": torch.randn(2, generator=g)},
                                  {"b": torch.randn(2, generator=g)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_round_trip_bitwise_with_bf16(tmp_path):
    tree = _ckpt_tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree)
    d = tmp_path / "step_0000000007"
    manifest = json.loads((d / "manifest.json").read_text())
    meta = manifest["arrays"]["params/h"]
    assert meta["dtype"] == "bfloat16"
    assert np.load(d / meta["file"]).dtype == np.uint16  # the bits
    assert set(manifest["arrays"]) == {"params/w", "params/h",
                                       "params/layers/0/b",
                                       "params/layers/1/b", "opt/step"}
    step, back = mgr.restore_latest(tree)
    assert step == 7
    assert isinstance(back["params"]["layers"], list)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(7, dict(tree, params=dict(tree["params"],
                                              w=torch.zeros(4, 3))))
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(7, dict(tree, extra=torch.zeros(1)))


def test_checkpoint_commit_is_atomic(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _ckpt_tree(1))
    calls = []
    real_save = np.save

    def failing_save(path, arr):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk full")
        real_save(path, arr)

    monkeypatch.setattr(np, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, _ckpt_tree(2))
    monkeypatch.setattr(np, "save", real_save)
    # the half-written step stays a .tmp and is never the latest
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001",
                                            "step_0000000002.tmp"]
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore(1, _ckpt_tree())["params"]["w"],
                       _ckpt_tree(1)["params"]["w"])
    # a later save of that step replaces the leftover .tmp
    mgr.save(2, _ckpt_tree(2))
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001",
                                            "step_0000000002"]


def test_checkpoint_keeps_n_and_async_snapshots(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _ckpt_tree()
    for step in range(1, 5):
        mgr.save_async(step, tree)
        before = tree["params"]["w"].clone()
        tree["params"]["w"].add_(1.0)  # the train step updates in place
        mgr.wait()
        back = mgr.restore(step, tree)
        assert torch.equal(back["params"]["w"], before)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]


def test_synthetic_images_follow_the_jax_rule(jx):
    cfg = _tiny_vit()
    kw = dict(num_patches=cfg.frontend.num_embeds,
              patch_dim=cfg.frontend.embed_dim, batch_size=6,
              num_classes=NUM_CLASSES, seed=3)
    data = SyntheticImages(device="cpu", **kw)
    jdata = jx.SyntheticImages(**kw)
    np.testing.assert_array_equal(data._readout.numpy(), jdata._readout)
    b = data.batch(5)
    assert b["patches"].shape == (6, cfg.frontend.num_embeds,
                                  cfg.frontend.embed_dim)
    assert b["patches"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
    # the JAX rule on these patches
    jb = jdata.batch(5)
    feats = jx.jnp.asarray(b["patches"].numpy()).mean(axis=1)
    want = jx.jnp.argmax(feats @ jx.jnp.asarray(jdata._readout,
                                                feats.dtype), axis=-1)
    np.testing.assert_array_equal(b["labels"].numpy(), np.asarray(want))
    assert np.asarray(jb["labels"]).dtype == np.int32
    # a pure function of (seed, step): a restarted stream repeats itself
    again = SyntheticImages(device="cpu", **kw).batch(5)
    assert torch.equal(again["patches"], b["patches"])
    assert not torch.equal(data.batch(6)["patches"], b["patches"])


def test_build_model_and_train_state():
    cfg = _tiny_vit()
    init, loss_fn, apply_fn = build_model(cfg)
    params = init(torch.Generator().manual_seed(0))
    batch = {"patches": torch.randn(2, cfg.frontend.num_embeds,
                                    cfg.frontend.embed_dim),
             "labels": torch.tensor([1, 2], dtype=torch.int32)}
    loss, metrics = loss_fn(params, batch)
    assert abs(float(loss) - np.log(1000)) < 1e-5  # the head starts at zero
    assert apply_fn(params, batch)[0].shape == (2, 1000)
    state = init_train_state(torch.Generator().manual_seed(0), init)
    assert int(state["opt"]["step"]) == 0
    assert all(not t.any() for t in tree_leaves(state["opt"]["mu"]))
    for t, ref in zip(tree_leaves(state["params"]),
                      tree_leaves(vit_init(torch.Generator().manual_seed(0),
                                           cfg))):
        assert torch.equal(t, ref)
    # ZeRO-1: bf16 compute params beside the f32 master (the plain init),
    # the moments over the master
    z = init_train_state(torch.Generator().manual_seed(0), init, zero1=True)
    assert set(z) == {"params", "master", "opt"}
    for p, m, ref in zip(tree_leaves(z["params"]), tree_leaves(z["master"]),
                         tree_leaves(state["params"])):
        assert torch.equal(m, ref) and m.dtype == torch.float32
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, ref.to(torch.bfloat16))
    for t, m in zip(tree_leaves(z["opt"]["nu"]), tree_leaves(z["master"])):
        assert t.dtype == m.dtype and t.shape == m.shape and not t.any()
    assert int(z["opt"]["step"]) == 0
    # the encoder-decoder: (encdec_init, its loss, encdec_apply)
    scfg = reduced(get_config("seamless-m4t-large-v2"))
    init, loss_fn, apply_fn = build_model(scfg)
    sparams = init(torch.Generator().manual_seed(0))
    assert {"enc_layers", "dec_blocks", "enc_norm"} <= set(sparams)
    assert len(sparams["enc_layers"]) == scfg.encoder_layers
    sbatch = {"tokens": torch.tensor([[1, 2, 3, 4]]),
              "embeds": torch.zeros(1, scfg.frontend.num_embeds,
                                    scfg.frontend.embed_dim)}
    loss, metrics = loss_fn(sparams, sbatch)
    assert set(metrics) == {"loss", "aux_loss"} and np.isfinite(float(loss))
    logits, (enc_out, _), _ = apply_fn(sparams, sbatch)
    assert logits.shape == (1, 4, scfg.vocab_size)
    assert enc_out.shape == (1, scfg.frontend.num_embeds, scfg.d_model)
    # the decoder-only LM: (init, next-token loss, apply)
    lcfg = reduced(get_config("qwen2-0.5b"))
    init, loss_fn, apply_fn = build_model(lcfg)
    params = init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, lcfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    loss, metrics = loss_fn(params, {"tokens": tokens})
    assert set(metrics) == {"loss", "aux_loss"}
    assert float(loss) == float(metrics["loss"]) > 0
    logits = apply_fn(params, {"tokens": tokens})[0]
    assert logits.shape == (2, 9, lcfg.vocab_size)
    nll = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, lcfg.vocab_size), tokens[:, 1:].reshape(-1))
    assert abs(float(loss) - float(nll)) < 1e-5


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=2.0, alpha=0.5)
    assert not wd.observe(0, 1.0) and wd.ewma == 1.0
    assert not wd.observe(1, 1.5) and wd.ewma == 1.25
    assert wd.observe(2, 3.0)  # slower than 2x the EWMA
    assert wd.ewma == 1.25  # a straggler does not move the EWMA
    assert wd.events == [{"step": 2, "dt": 3.0, "ewma": 1.25}]
