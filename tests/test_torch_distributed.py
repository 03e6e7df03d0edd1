"""The port's distributed training path on ``torch.distributed``, on
reduced ``llama3-8b`` in f32 (the reference's sharded test's arch).

- (a) ``init_train_state(zero1=True)`` and two ZeRO-1 steps without a
  mesh against the JAX package's no-mesh ZeRO-1 step from the same
  weights, clipping active: losses (rtol), master and moments within
  1e-5; the bf16 ``params`` equal the master cast to bf16, bitwise; and
  the port's own ZeRO-1 init against its plain init.
- (b) ``train_state_from_jax`` carries a ZeRO-1 state across.
- (c) On 4 gloo ranks (one spawn for the file), ZeRO-1 and FSDP steps
  with microbatches 2 and clipping active over the meshes (data=4,
  model=1), (data=2, model=2) and (data=2, model=2) with
  ``dp_over_model``: after 2 steps each rank's gathered master and
  moments equal the one-process step's on the global batch within 1e-5,
  its grad norm the one-process norm (each element counted once), and
  ZeRO-1's compute params the master cast to bf16, bitwise. ZeRO-1's
  gradients are taken w.r.t. bf16 params, so they round to bf16 once a
  microbatch, as the reference's do: its one-process step cuts the global
  batch into the ranks' microbatches (2 per batch shard), which round
  where the ranks' round. Cut into 2, 34 of 16384 embedding elements
  read up to 1.5e-3 apart after 2 steps: AdamW's first step turns a bf16
  ulp of a near-zero gradient into up to the learning rate.
- (d) The elastic restore, as ``tests/test_checkpoint_elastic.py``: a
  ZeRO-1 state saved from (2, 2) restores onto (4, 1), onto a 1-D (4,)
  mesh and with no mesh, bitwise equal to what was saved; a
  ``make_host_mesh`` of one rank on the CPU starts and ends its own
  process group.

The JAX reference is imported by the ``jx`` fixture, so that the ranks
(which import this module) never load jax.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.convert import train_state_from_jax
from repro_torch.distributed import ShardingOptions, use_mesh
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import OptimizerConfig, tree_leaves, tree_map
from repro_torch.train import (
    init_train_state,
    jit_train_step,
    make_train_step,
    state_shardings,
)

ARCH = "llama3-8b"
WORLD = 4
# constant lr, clipping active: the reduced model's gradient norm is ~1
OCFG = OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup_steps=0,
                       total_steps=10**9, cooldown_steps=1,
                       grad_clip_norm=0.05)
# the reduced params are far below the 2**16 FSDP threshold
OPTS = ShardingOptions(fsdp_min_size=0)
MESHES = [((4, 1), False), ((2, 2), False), ((2, 2), True)]
MESH_IDS = ["data4-model1", "data2-model2", "data2-model2-dp_over_model"]


def _cfg():
    return dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")


def _batch(i, cfg, rows=8, seq=17):
    toks = np.random.RandomState(100 + i).randint(0, cfg.vocab_size,
                                                  (rows, seq))
    return {"tokens": torch.from_numpy(toks.astype(np.int32))}


def _state_parts(state):
    """(master, mu, nu) of a state, as plain tensors."""
    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    master = state.get("master", state["params"])
    return tuple(tree_map(whole, t) for t in
                 (master, state["opt"]["mu"], state["opt"]["nu"]))


def _one_process(zero1, microbatches, steps=2):
    cfg = _cfg()
    init, loss_fn, _ = build_model(cfg)
    state = init_train_state(torch.Generator().manual_seed(0), init,
                             zero1=zero1)
    step = make_train_step(loss_fn, OCFG, microbatches=microbatches)
    norms = []
    for i in range(steps):
        state, m = step(state, _batch(i, cfg))
        norms.append(float(m["grad_norm"]))
    return state, norms


def _data_only(mesh, tree):
    """A 1-D data mesh's placements: axis 0 over data where it divides,
    else replicated (the reference's elastic test writes its shardings
    by hand too)."""
    n = mesh.shape[0]
    return tree_map(lambda t: (Shard(0),) if t.ndim and t.shape[0] % n == 0
                    else (Replicate(),), tree)


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD)
    try:
        cfg = _cfg()
        init, loss_fn, _ = build_model(cfg)
        out = {}
        for zero1 in (True, False):
            for (shape, dpm), name in zip(MESHES, MESH_IDS):
                mesh = make_mesh(shape, ("data", "model"), device="cpu")
                with use_mesh(mesh, dp_over_model=dpm):
                    state = init_train_state(
                        torch.Generator().manual_seed(0), init, zero1=zero1)
                    sh = state_shardings(mesh, state, OPTS)
                step = jit_train_step(
                    make_train_step(loss_fn, OCFG, microbatches=2), mesh, sh)
                norms = []
                with use_mesh(mesh, dp_over_model=dpm):
                    for i in range(2):
                        state, m = step(state, _batch(i, cfg))
                        norms.append(float(m["grad_norm"]))
                rec = {"parts": _state_parts(state), "norms": norms,
                       "placed": [tuple(t.placements)
                                  for t in tree_leaves(state)]}
                if zero1:
                    rec["cast_ok"] = all(
                        torch.equal(p.full_tensor(),
                                    m.full_tensor().to(torch.bfloat16))
                        for p, m in zip(tree_leaves(state["params"]),
                                        tree_leaves(state["master"])))
                out[(zero1, name)] = rec
                if zero1 and name == "data2-model2":
                    saved = state
        # (d) the elastic restore of the (2, 2) ZeRO-1 state
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(3, saved)
        want = tree_map(lambda t: t.full_tensor(), saved)
        mesh41 = make_mesh((4, 1), ("data", "model"), device="cpu")
        mesh4 = make_mesh((4,), ("data",), device="cpu")
        with use_mesh(mesh41):
            on41 = mgr.restore(3, saved,
                               shardings=state_shardings(mesh41, saved, OPTS))
        with use_mesh(mesh4):
            on4 = mgr.restore(3, saved, shardings=_data_only(mesh4, saved))
        plain = mgr.restore(3, saved, device="cpu")
        eq = {}
        for label, got in (("(4, 1)", on41), ("(4,)", on4), ("none", plain)):
            leaves = tree_leaves(got)
            eq[label] = (
                all(isinstance(t, DTensor) == (label != "none")
                    for t in leaves),
                all(torch.equal(
                    g.full_tensor() if isinstance(g, DTensor) else g, w)
                    and g.dtype == w.dtype
                    for g, w in zip(leaves, tree_leaves(want))))
        out["restore"] = eq
        out["on41_placements"] = [tuple(t.placements)
                                  for t in tree_leaves(on41)]
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results of (c) and (d), from one spawn."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    mp.spawn(_rank_main, args=(tmp,), nprocs=WORLD, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _batch_shards(mesh):
    shape, dp_over_model = MESHES[MESH_IDS.index(mesh)]
    return shape[0] * (shape[1] if dp_over_model else 1)


@pytest.fixture(scope="module")
def one_process():
    """The one-process steps on the global batch: FSDP's in 2
    microbatches, ZeRO-1's in the ranks' microbatches (module doc)."""
    out = {(False, 2): _one_process(False, 2)}
    for n in sorted({_batch_shards(m) for m in MESH_IDS}):
        out[(True, 2 * n)] = _one_process(True, 2 * n)
    return out


def _close(got, want, tol=1e-5):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_sharded_steps_match_one_process(ranks, one_process, zero1, mesh):
    state, norms = one_process[
        (zero1, 2 * _batch_shards(mesh) if zero1 else 2)]
    want = _state_parts(state)
    assert min(norms) > OCFG.grad_clip_norm  # clipping is active
    for rank, res in enumerate(ranks):
        rec = res[(zero1, mesh)]
        for got, ref in zip(rec["parts"], want):
            _close(got, ref)
        np.testing.assert_allclose(rec["norms"], norms, rtol=1e-5)
        if zero1:
            assert rec["cast_ok"], rank
    # the state really was sharded: some leaf over each mesh axis
    placed = ranks[0][(zero1, mesh)]["placed"]
    assert any(Shard(0) in p or Shard(1) in p for p in placed)
    if mesh == "data2-model2":  # TP on: some leaf shards over model
        assert any(not isinstance(p[1], Replicate) for p in placed)
    if mesh == "data2-model2-dp_over_model":  # model is a batch axis
        assert all(isinstance(p[1], Replicate) for p in placed)


def test_elastic_restore_across_meshes(ranks):
    for res in ranks:
        for label, (kind_ok, equal) in res["restore"].items():
            assert kind_ok and equal, label
    assert any(Shard(0) in p for p in ranks[0]["on41_placements"])


def test_host_mesh_of_one_rank_on_the_cpu():
    """Without a process group, ``make_host_mesh`` starts one of one rank
    (gloo on the CPU); the mesh's step is the one-process step."""
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        assert dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 256 ranks"):
            from repro_torch.launch.mesh import make_production_mesh

            make_production_mesh(device="cpu")
        cfg = _cfg()
        init, loss_fn, _ = build_model(cfg)
        state = init_train_state(torch.Generator().manual_seed(0), init,
                                 zero1=True)
        with use_mesh(mesh):
            sh = state_shardings(mesh, state, OPTS)
        step = jit_train_step(make_train_step(loss_fn, OCFG), mesh, sh)
        ref, _ = _one_process(True, 1, steps=1)
        with use_mesh(mesh):
            state, m = step(state, _batch(0, cfg))
        for got, want in zip(_state_parts(state), _state_parts(ref)):
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(g, w)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------------
# (a), (b): one process, against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild_model
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train.step import init_train_state as jinit_train_state
    from repro.train.step import make_train_step as jmake_train_step

    cfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="float32")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, build_model=jbuild_model,
        OptimizerConfig=JOptimizerConfig, init_train_state=jinit_train_state,
        make_train_step=jmake_train_step)


def _np_tree(jx, tree):
    return jx.jax.tree_util.tree_map(np.asarray, tree)


def test_zero1_state_and_steps_match_jax(jx):
    init, loss_fn, _ = jx.build_model(jx.cfg)
    jstate = jx.init_train_state(jx.jax.random.PRNGKey(0), init, zero1=True)
    assert set(jstate) == {"params", "master", "opt"}
    cfg = _cfg()
    state = train_state_from_jax(_np_tree(jx, jstate), cfg, device="cpu")
    for p, m in zip(tree_leaves(state["params"]),
                    tree_leaves(state["master"])):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p, m.to(torch.bfloat16))
    jocfg = jx.OptimizerConfig(**dataclasses.asdict(OCFG))
    jstep = jx.jax.jit(jx.make_train_step(loss_fn, jocfg))
    step = make_train_step(build_model(cfg)[1], OCFG)
    for i in range(2):
        b = _batch(i, cfg)
        jstate, jm = jstep(jstate, {"tokens": jx.jnp.asarray(b["tokens"])})
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["total_loss"]),
                                   float(jm["total_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(m["grad_norm"]) > OCFG.grad_clip_norm
    want = train_state_from_jax(_np_tree(jx, jstate), cfg, device="cpu")
    assert int(state["opt"]["step"]) == int(want["opt"]["step"]) == 2
    for part in ("master", "mu", "nu"):
        got = state[part] if part == "master" else state["opt"][part]
        ref = want[part] if part == "master" else want["opt"][part]
        _close(got, ref)
    for p, m in zip(tree_leaves(state["params"]),
                    tree_leaves(state["master"])):
        assert torch.equal(p, m.to(torch.bfloat16))


def test_port_zero1_init_is_the_plain_init_cast():
    init, _, _ = build_model(_cfg())
    z = init_train_state(torch.Generator().manual_seed(0), init, zero1=True)
    plain = init_train_state(torch.Generator().manual_seed(0), init)
    assert set(z) == {"params", "master", "opt"}
    for p, m, ref in zip(tree_leaves(z["params"]), tree_leaves(z["master"]),
                         tree_leaves(plain["params"])):
        assert torch.equal(m, ref)
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, ref.to(torch.bfloat16))
    assert int(z["opt"]["step"]) == 0
    for t, m in zip(tree_leaves(z["opt"]["mu"]), tree_leaves(z["master"])):
        assert t.dtype == m.dtype == torch.float32 and not t.any()


def test_train_state_from_jax_carries_zero1(jx):
    init, _, _ = jx.build_model(jx.cfg)
    jstate = jx.init_train_state(jx.jax.random.PRNGKey(1), init, zero1=True)
    state = train_state_from_jax(_np_tree(jx, jstate), _cfg(), device="cpu")
    assert set(state) == {"params", "master", "opt"}
    jleaves = {
        part: [np.asarray(x) for x in jx.jax.tree_util.tree_leaves(t)]
        for part, t in (("params", jstate["params"]),
                        ("master", jstate["master"]))}
    for part in ("params", "master"):
        got = tree_leaves(state[part])
        assert sum(t.numel() for t in got) == sum(
            a.size for a in jleaves[part])
        for t in got:
            assert t.dtype == (torch.bfloat16 if part == "params"
                               else torch.float32)
    # layer 0's attention query weight, as the JAX segment stacks it
    wq = np.asarray(jstate["master"]["segments"][0]["attn"]["wq"][0])
    np.testing.assert_array_equal(
        state["master"]["layers"][0]["attn"]["wq"].numpy(), wq)
    wq16 = np.asarray(jstate["params"]["segments"][0]["attn"]["wq"][0]
                      .astype(jx.jnp.float32))
    np.testing.assert_array_equal(
        state["params"]["layers"][0]["attn"]["wq"].float().numpy(), wq16)


def test_zero1_kernel_path_hands_the_kernels_f32_phi(monkeypatch):
    """A ZeRO-1 state's compute params are bf16, phi and scale included;
    the kernels take phi_n in f32 (the reference's widen it inside), so
    the Soft-MoE layer widens it after normalizing it in bf16. On the
    CPU the wrappers run their plain versions, which widen it too, so
    the dtypes reaching them are recorded."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(
        reduced(get_config("granite-moe-1b-a400m+soft")), dtype="float32")
    init = build_model(cfg)[0]
    state = init_train_state(torch.Generator().manual_seed(0), init,
                             zero1=True)
    seen = []
    for name in ("soft_moe_routing", "soft_moe_combine"):
        inner = getattr(ops, name)

        def spy(x, phi_n, *a, _inner=inner, **kw):
            seen.append(phi_n.dtype)
            return _inner(x, phi_n, *a, **kw)

        monkeypatch.setattr(ops, name, spy)
    from repro_torch.models import lm_loss

    b = _batch(0, cfg)
    got = lm_loss(state["params"], cfg, b, use_kernel=True)[0]
    want = lm_loss(state["params"], cfg, b)[0]
    assert seen and set(seen) == {torch.float32}
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
