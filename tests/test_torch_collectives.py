"""The port's collectives against the JAX package's functions.

- (a) ``_bucket_by_device`` against the reference's, in this process, on
  inputs with drops: send buffers, expert slots, validity, positions and
  the kept mask bitwise.
- (b) ``a2a_route_and_compute`` (through ``make_a2a_moe``) on 4 gloo
  ranks against the reference's ``a2a_route_and_compute`` run under
  ``jax.vmap(..., axis_name="model")`` on the same per-rank inputs, at
  ``capacity_factor`` 8.0 (no drops; also against the dense dropless
  top-k of ``tests/test_a2a_routing.py``) and 0.5 (the same (token,
  choice) pairs dropped, some), within 1e-5 (f32).
- (c) ``quantize_int8``, ``dequantize_int8`` and
  ``compress_with_feedback`` against the reference's within one f32 ulp
  (an all-zero tensor included).
- (d) ``_reduce_leaf`` and ``pod_allreduce_compressed`` on 4 ranks, as
  pod=4 (plain local tensors) and as (pod=2, data=2) (DTensor leaves, a
  leaf sharded over data), against the reference's ``_reduce_leaf``
  under ``jax.vmap(..., axis_name="pod")``, the error-feedback residual
  carried through 3 rounds, within one f32 ulp; ``pod_allreduce_mean``
  equals the mean.
- ``constrain`` redistributes a DTensor onto its logical layout with the
  divisibility fallback, ``axis_size`` reads a mesh dimension's group.

One spawn of 4 ranks runs (b), (d) and the last item; the JAX side runs
in this process (the ``jx`` fixture), never in the ranks.
"""
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.distributed import constrain, use_mesh
from repro_torch.distributed.a2a_routing import _bucket_by_device, make_a2a_moe
from repro_torch.distributed.compat import axis_size
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import (
    compress_with_feedback,
    dequantize_int8,
    ef_state_init,
    pod_allreduce_compressed,
    pod_allreduce_mean,
    quantize_int8,
)
from repro_torch.optim.compression import _reduce_leaf

WORLD = 4
E, K, D, FF, T = 16, 2, 32, 64, 32  # T tokens a rank
CFS = (8.0, 0.5)
ROUNDS = 3


def _moe_inputs():
    """Tokens of each rank (4, T, D), the router and all experts."""
    rng = np.random.RandomState(0)
    x = rng.randn(WORLD, T, D).astype(np.float32)
    router = (rng.randn(D, E) * 0.1).astype(np.float32)
    wg, wu = ((rng.randn(E, D, FF) * 0.05).astype(np.float32)
              for _ in range(2))
    wd = (rng.randn(E, FF, D) * 0.05).astype(np.float32)
    return x, router, wg, wu, wd


def _pod_grads(r):
    """Round r's gradients of the 4 (pod, data) positions: a tree with
    an (8, 16) leaf and a (16,) leaf per pod, over 4 pods."""
    rng = np.random.RandomState(10 + r)
    return {"w": rng.randn(WORLD, 8, 16).astype(np.float32),
            "b": (rng.randn(WORLD, 16) * 1e-3).astype(np.float32)}


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD)
    try:
        out = {}
        # (b) the all-to-all MoE layer over a 4-way model axis
        x, router, wg, wu, wd = (torch.from_numpy(a) for a in _moe_inputs())
        mesh = make_mesh((WORLD,), ("model",), device="cpu")
        epd = E // WORLD
        mine = slice(rank * epd, (rank + 1) * epd)
        for cf in CFS:
            moe = make_a2a_moe(mesh, E, K, D, capacity_factor=cf)
            out[("a2a", cf)] = moe(x[rank], router, wg[mine], wu[mine],
                                   wd[mine])
        out["axis_size"] = axis_size("model", mesh)
        # (d) the compressed pod reduce, pod=4: plain local tensors
        mesh = make_mesh((WORLD,), ("pod",), device="cpu")
        specs = {"w": (Replicate(),), "b": (Replicate(),)}
        err = None
        for r in range(ROUNDS):
            g = {k: torch.from_numpy(v[rank]) for k, v in
                 _pod_grads(r).items()}
            err = ef_state_init(g) if err is None else err
            red, err = pod_allreduce_compressed(g, err, mesh, specs)
            out[("pod4", r)] = (red, err)
            if r == 0:
                out["mean4"] = pod_allreduce_mean(g, mesh, specs)
                leaf, leaf_err = _reduce_leaf(
                    g["w"], torch.zeros(8, 16), mesh.get_group("pod"))
                out["leaf4"] = (leaf, leaf_err)
        # (pod=2, data=2): DTensor leaves, "w" sharded over data on axis 0
        mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
        pod, dat = mesh.get_coordinate()
        specs = {"w": (Replicate(), Shard(0)), "b": (Replicate(),
                                                     Replicate())}
        err = None
        for r in range(ROUNDS):
            full = _pod_grads(r)
            g = {"w": DTensor.from_local(
                     torch.from_numpy(full["w"][pod][dat * 4:(dat + 1) * 4]),
                     mesh, specs["w"], run_check=False),
                 "b": DTensor.from_local(torch.from_numpy(full["b"][pod]),
                                         mesh, specs["b"], run_check=False)}
            if err is None:
                err = {k: DTensor.from_local(
                    torch.zeros_like(v.to_local()), mesh, specs[k],
                    run_check=False) for k, v in g.items()}
            red, err = pod_allreduce_compressed(g, err, mesh, specs)
            out[("pod2x2", r)] = (
                {k: (type(v).__name__, tuple(v.placements), v.to_local())
                 for k, v in red.items()},
                {k: v.to_local() for k, v in err.items()})
        # constrain on a real mesh: (8, 6) onto ("batch", "model"), and
        # (8, 5), whose 5 columns do not split over model = 2
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        for cols in (6, 5):
            full = torch.arange(8 * cols, dtype=torch.float32).view(8, cols)
            xd = distribute_tensor(full, mesh, (Replicate(), Replicate()),
                                   src_data_rank=None)
            with use_mesh(mesh):
                y = constrain(xd, "batch", "model")
            out[("constrain", cols)] = (tuple(y.placements),
                                        torch.equal(y.full_tensor(), full))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("coll"))
    mp.spawn(_rank_main, args=(tmp,), nprocs=WORLD, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.distributed import a2a_routing as ja2a
    from repro.optim import compression as jcomp

    return types.SimpleNamespace(jax=jax, jnp=jnp, a2a=ja2a, comp=jcomp)


def test_bucket_by_device_matches_jax(jx):
    rng = np.random.RandomState(1)
    t, k, nd, epd, d = 40, 3, 4, 2, 8
    x = rng.randn(t, d).astype(np.float32)
    idx = rng.randint(0, nd * epd, (t, k)).astype(np.int32)
    idx[:20] = 0  # crowd device 0 past the capacity: drops
    gate = rng.rand(t, k).astype(np.float32)
    for cap in (6, 80):
        want = jx.a2a._bucket_by_device(jx.jnp.asarray(x),
                                        jx.jnp.asarray(idx),
                                        jx.jnp.asarray(gate), nd, epd, cap)
        got = _bucket_by_device(torch.from_numpy(x),
                                torch.from_numpy(idx).long(),
                                torch.from_numpy(gate), nd, epd, cap)
        for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert bool((~got[3][2]).any()) == (cap == 6)  # 60 pairs to 0


def _jax_a2a(jx, cf):
    x, router, wg, wu, wd = _moe_inputs()
    epd = E // WORLD
    jnp, jax = jx.jnp, jx.jax

    def per_rank(xr, g, u, dn):
        def expert_fn(le, toks):
            h = jax.nn.silu(toks @ g[le]) * (toks @ u[le])
            return h @ dn[le]

        return jx.a2a.a2a_route_and_compute(
            xr, jnp.asarray(router), expert_fn, axis_name="model",
            num_experts=E, top_k=K, capacity_factor=cf)

    def loc(w):  # each rank's experts
        return jnp.asarray(w.reshape(WORLD, epd, *w.shape[1:]))

    return np.asarray(jax.vmap(per_rank, axis_name="model")(
        jnp.asarray(x), loc(wg), loc(wu), loc(wd)))


def _dense_reference():
    """Dense dropless top-k, as tests/test_a2a_routing.py computes it."""
    x, router, wg, wu, wd = (torch.from_numpy(a) for a in _moe_inputs())
    x = x.reshape(WORLD * T, D)
    probs = torch.softmax(x @ router, -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, :K], order.indices[:, :K]
    gate_n = gate / gate.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for kk in range(K):
        e = idx[:, kk]
        g = torch.nn.functional.silu(torch.einsum("td,tdf->tf", x, wg[e]))
        u = torch.einsum("td,tdf->tf", x, wu[e])
        ref = ref + gate_n[:, kk, None] * torch.einsum("tf,tfd->td", g * u,
                                                       wd[e])
    return ref.reshape(WORLD, T, D)


@pytest.mark.parametrize("cf", CFS)
def test_a2a_route_and_compute_matches_jax(jx, ranks, cf):
    got = np.stack([res[("a2a", cf)].numpy() for res in ranks])
    want = _jax_a2a(jx, cf)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert all(res["axis_size"] == WORLD for res in ranks)
    dense = _dense_reference().numpy()
    # which (token, choice) pairs drop: the ranks bucket locally, so each
    # rank's kept mask is _bucket_by_device of its own routing (held
    # against the reference's in the test above)
    x, router = (torch.from_numpy(a) for a in _moe_inputs()[:2])
    cap = max(int(cf * K * T / WORLD), 1)
    kept = []
    for r in range(WORLD):
        probs = torch.softmax(x[r] @ router, -1)
        idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
        kept.append(_bucket_by_device(x[r], idx[:, :K], None, WORLD,
                                      E // WORLD, cap)[3][2])
    kept = torch.stack(kept).view(WORLD, T, K)
    if cf == 8.0:  # slack: no drops, the dense dropless top-k
        assert kept.all()
        np.testing.assert_allclose(got, dense, rtol=0, atol=1e-5)
    else:
        assert not kept.all() and kept.any()
        whole = kept.all(-1).numpy()  # tokens that kept both choices
        np.testing.assert_allclose(got[whole], dense[whole], rtol=0,
                                   atol=1e-5)
        assert np.abs(got[~whole] - dense[~whole]).max() > 1e-3


def _ulp_close(got, want):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32), maxulp=1)


def test_int8_functions_match_jax(jx):
    rng = np.random.RandomState(2)
    for x in (rng.randn(64, 33).astype(np.float32) * 3.0,
              np.zeros((5, 7), np.float32),
              np.array([0.5, -0.5, 1.5, 2.5, 127.0], np.float32)):
        err = (rng.randn(*x.shape) * 0.01).astype(np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = jx.comp.quantize_int8(jx.jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        _ulp_close(s.numpy(), js)
        _ulp_close(dequantize_int8(q, s).numpy(),
                   jx.comp.dequantize_int8(jq, js))
        q, s, e = compress_with_feedback(torch.from_numpy(x),
                                         torch.from_numpy(err))
        jq, js, je = jx.comp.compress_with_feedback(jx.jnp.asarray(x),
                                                    jx.jnp.asarray(err))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        _ulp_close(s.numpy(), js)
        _ulp_close(e.numpy(), je)


def _jax_rounds(jx, blocks):
    """The reference's ``_reduce_leaf`` under ``vmap`` over "pod", the
    residual carried: blocks(r) -> (pods, ...) gradients of round r."""
    fn = jx.jax.vmap(lambda g, e: jx.comp._reduce_leaf(g, e, "pod"),
                     axis_name="pod")
    err, out = None, []
    for r in range(ROUNDS):
        g = jx.jnp.asarray(blocks(r))
        err = jx.jnp.zeros_like(g) if err is None else err
        red, err = fn(g, err)
        out.append((np.asarray(red), np.asarray(err)))
    return out


def test_reduce_leaf_and_pod_reduce_match_jax(jx, ranks):
    for key in ("w", "b"):
        want = _jax_rounds(jx, lambda r: _pod_grads(r)[key])
        for r, (red, err) in enumerate(want):
            for p, res in enumerate(ranks):
                got, got_err = res[("pod4", r)]
                _ulp_close(got[key].numpy(), red[p])
                _ulp_close(got_err[key].numpy(), err[p])
        # the reduce is a mean within one shared scale per round
        g0 = _pod_grads(0)[key]
        scale = np.abs(g0).max() / 127.0
        assert np.abs(want[0][0][0] - g0.mean(0)).max() <= scale
    # _reduce_leaf alone is the tree reduce's leaf (held above); the
    # uncompressed mean is the mean
    g0 = _pod_grads(0)
    for res in ranks:
        leaf, leaf_err = res["leaf4"]
        assert torch.equal(leaf, res[("pod4", 0)][0]["w"])
        assert torch.equal(leaf_err, res[("pod4", 0)][1]["w"])
        for key in ("w", "b"):
            np.testing.assert_allclose(
                res["mean4"][key].numpy(), g0[key].mean(0), rtol=0,
                atol=1e-6 * np.abs(g0[key]).max())  # sums in other orders
    # (pod=2, data=2): rank (p, d) holds data shard d of pod p's gradient;
    # the reference reduces each data shard's blocks over the two pods
    for key in ("w", "b"):
        for dat in range(2):
            def blocks(r, key=key, dat=dat):
                g = _pod_grads(r)[key][:2]
                return g[:, dat * 4:(dat + 1) * 4] if key == "w" else g

            want = _jax_rounds(jx, blocks)
            for r, (red, err) in enumerate(want):
                for pod in range(2):
                    res = ranks[pod * 2 + dat][("pod2x2", r)]
                    kind, placed, local = res[0][key]
                    assert kind == "DTensor"
                    assert placed == ((Replicate(), Shard(0)) if key == "w"
                                      else (Replicate(), Replicate()))
                    _ulp_close(local.numpy(), red[pod])
                    _ulp_close(res[1][key].numpy(), err[pod])


def test_constrain_redistributes_a_dtensor(ranks):
    for res in ranks:
        placed, same = res[("constrain", 6)]
        assert placed == (Shard(0), Shard(1)) and same
        placed, same = res[("constrain", 5)]  # 5 % 2: model dropped
        assert placed == (Shard(0), Replicate()) and same
