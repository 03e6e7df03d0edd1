"""The port's dry-run (``launch/dryrun.py``, ``launch/specs.py``,
``roofline/collectives.py``) on fake process groups of 256 and 512
ranks:

- ``record_collectives()`` around hand-placed DTensors on a 16×16 mesh
  counts the all-gathers and the reduce-scatter that a hand count gives
  (bytes, counts, group sizes), and on a 2×16×16 mesh marks the reduce
  over ``pod`` as crossing pods and the one over ``data`` as not;
- ``run_cell`` runs reduced qwen2-0.5b ``train_4k`` (plain and ZeRO-1)
  and ``decode_32k``, and reduced granite-moe-1b-a400m+soft
  ``train_4k``, to ``"status": "ok"``, with collectives recorded from
  the program; its ``args_bytes_per_dev`` equals the sum taken from the
  JAX ``param_specs`` and the mesh's axis sizes, its analytic terms equal
  the JAX ``analytic_cost``, and no process group is left behind;
- ``--use-kernel`` is refused with a clear error;
- ``hillclimb.main`` with one tag appends one line to its output file.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import contextlib
import json
import math
import types

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.launch import dryrun, hillclimb
from repro_torch.roofline.collectives import record_collectives


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.distributed.sharding import ShardingOptions, param_specs
    from repro.models import build_model
    from repro.roofline.flops import analytic_cost
    from repro.train.step import init_train_state

    return types.SimpleNamespace(
        jax=jax, get_config=jget_config, reduced=jreduced,
        ShardingOptions=ShardingOptions, param_specs=param_specs,
        build_model=build_model, analytic_cost=analytic_cost,
        init_train_state=init_train_state)


@pytest.fixture
def reduced_cells(monkeypatch):
    """``run_cell`` on the reduced configs (the full ones are the CLI's)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: reduced(get_config(name)))


@contextlib.contextmanager
def _fake_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    assert dryrun._fake_group(math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_record_collectives_counts_by_hand():
    with _fake_mesh((16, 16), ("data", "model")) as mesh:
        w = DTensor.from_local(_meta(4, 2), mesh, (Shard(0), Shard(1)),
                               shape=(64, 32), stride=(32, 1))
        g = DTensor.from_local(_meta(64, 32), mesh, (Partial(), Replicate()))
        with record_collectives() as rec:
            w.full_tensor()  # two all-gathers, over model and over data
            g.redistribute(mesh, (Shard(0), Replicate()))  # reduce-scatter
        mc = rec.module
        assert mc.counts() == {"all-gather": 2, "reduce-scatter": 1}
        # results: (4, 2) gathered 16x = 128 f32, then 16x again = 2048;
        # the reduce-scatter's shard (4, 32)
        assert sorted(c.bytes for c in mc.collectives
                      if c.kind == "all-gather") == [512, 8192]
        assert mc.by_kind() == {"all-gather": 8704, "reduce-scatter": 512}
        assert {c.group_size for c in mc.collectives} == {16}
        assert not any(c.crosses_pod for c in mc.collectives)
        assert mc.weighted_ici_bytes() == pytest.approx(
            (8704 + 512) * 15 / 16)
    assert not dist.is_initialized()


def test_record_collectives_marks_pod_crossing():
    with _fake_mesh((2, 16, 16), ("pod", "data", "model")) as mesh:
        g = DTensor.from_local(_meta(8, 8), mesh,
                               (Partial(), Partial(), Replicate()))
        with record_collectives(pod_size=256) as rec:
            g.redistribute(mesh, (Replicate(),) * 3)  # two all-reduces
        by = {c.group_size: c for c in rec.module.collectives}
        assert set(by) == {2, 16}
        assert by[2].kind == by[16].kind == "all-reduce"
        assert by[2].crosses_pod and not by[16].crosses_pod
        assert rec.module.weighted_pod_bytes() == 256 * 1.0
        assert rec.module.weighted_ici_bytes() == 256 * 2 * 15 / 16


def _jax_args_bytes(jx, arch, zero1):
    """Per-device bytes of the JAX train state (FSDP, or ZeRO-1's bf16
    compute params without it) and batch under the logical specs, on a
    (data=16, model=16) mesh, each dim split where it divides."""
    cfg = jx.reduced(jx.get_config(arch))
    init_fn = jx.build_model(cfg)[0]
    state = jx.jax.eval_shape(
        lambda r: jx.init_train_state(r, init_fn, zero1=zero1),
        jx.jax.random.PRNGKey(0))
    sizes = {"data": 16, "model": 16, None: 1}

    def tree(params, opts):
        specs = jx.param_specs(params, opts)
        total = 0
        for leaf, spec in zip(jx.jax.tree_util.tree_leaves(params),
                              jx.jax.tree_util.tree_leaves(
                                  specs, is_leaf=lambda x: isinstance(
                                      x, tuple))):
            dims = [d // sizes[n] if d % sizes[n] == 0 else d
                    for d, n in zip(leaf.shape, spec)]
            total += math.prod(dims) * leaf.dtype.itemsize
        return total

    opts = jx.ShardingOptions()
    if zero1:  # bf16 compute params, f32 master and moments
        total = (tree(state["params"], jx.ShardingOptions(fsdp=False))
                 + 3 * tree(state["master"], opts))
    else:  # f32 params and moments
        total = 3 * tree(state["params"], opts)
    shape = SHAPES["train_4k"]
    # the step counter (int32) and this rank's rows of int32 tokens
    return total + 4 + shape.global_batch // 16 * shape.seq_len * 4


@pytest.mark.parametrize("arch,shape,zero1", [
    ("qwen2-0.5b", "train_4k", False),
    ("qwen2-0.5b", "train_4k", True),
    ("qwen2-0.5b", "decode_32k", False),
    ("granite-moe-1b-a400m+soft", "train_4k", False),
], ids=["qwen-train", "qwen-train-zero1", "qwen-decode", "granite-soft"])
def test_run_cell(jx, reduced_cells, arch, shape, zero1):
    r = dryrun.run_cell(arch, shape, zero1=zero1, verbose=False)
    assert not dist.is_initialized()
    assert r["status"] == "ok" and r["chips"] == 256 and r["mesh"] == "16x16"
    want = jx.analytic_cost(jx.reduced(jx.get_config(arch)), shape)
    flops, nbytes = want.per_device(256)
    assert r["analytic"]["flops_per_dev"] == flops
    assert r["analytic"]["bytes_per_dev"] == nbytes
    counts = r["collectives"]["counts"]
    assert counts.get("all-gather", 0) > 0  # the params gathered whole
    if SHAPES[shape].mode == "train":
        assert r["memory"]["args_bytes_per_dev"] == _jax_args_bytes(
            jx, arch, zero1)
        # the gradients onto the master's placements: reduce-scatters
        # where the master shards, all-reduces of the rest
        assert counts.get("reduce-scatter", 0) + counts["all-reduce"] > 0
    assert r["memory"]["temp_bytes_per_dev"] is None
    assert r["hlo_cost"] is None
    rf = r["roofline"]
    assert rf["bound_s"] == max(rf["t_compute_s"], rf["t_memory_s"],
                                rf["t_collective_s"]) > 0


def test_use_kernel_is_refused(reduced_cells):
    with pytest.raises(ValueError, match="meta device"):
        dryrun.run_cell("qwen2-0.5b", "decode_32k", use_kernel=True,
                        verbose=False)
    assert not dist.is_initialized()


def test_hillclimb_appends_one_line(reduced_cells, monkeypatch, tmp_path):
    out = tmp_path / "results" / "perf.jsonl"
    monkeypatch.setattr(hillclimb, "OUT", str(out))
    hillclimb.main(["qwen05b_pure_dp_zero1"])
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["tag"] == "qwen05b_pure_dp_zero1" and r["status"] == "ok"
    hillclimb.main(["qwen05b_pure_dp_zero1"])  # done: not run again
    assert len(out.read_text().splitlines()) == 1
