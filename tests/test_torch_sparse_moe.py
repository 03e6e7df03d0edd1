"""The port's sparse MoE baselines and routing ablations against the JAX
package: ``tokens_choice_apply`` / ``experts_choice_apply`` in train
mode (groups of one and two sequences, BPR on and off, a tight capacity
whose drops land on an expert's last kept slot, shared experts, tied
router scores), in the serving modes (per row, dropless) and through the
``batch_coupled`` hatch; outputs, ``moe_aux_loss``, ``dropped_fraction``,
the telemetry tree with its ``rows``, the routing decisions and the
gradients of x, the router and the experts. The four ablations, forward
and gradient, against ``ablation_apply``. Inside the port: a serving-mode
row alone equals the same row in a batch.

Tolerances: f32 outputs and metrics within 1e-5 of max|ref|, gradients
within 1e-4; routing decisions equal. Never bitwise against JAX (its
own sparse path drifts by ~4e-7 between equivalent calls on this jax).

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.core import ablation_apply, moe_apply, moe_init
from repro_torch.core import sparse_moe

B, M, D, E, DFF = 4, 8, 16, 4, 16
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import MoEConfig as JaxMoEConfig
    from repro.core import ablation_apply, ablation_init
    from repro.core import sparse_moe as jax_sparse

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, MoEConfig=JaxMoEConfig, sparse=jax_sparse,
        ablation_apply=ablation_apply, ablation_init=ablation_init)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _np_tree(tree):
    return _map(tree, np.asarray)


def _torch_tree(tree, requires_grad=False):
    return _map(tree, lambda a: torch.tensor(np.array(a),
                                             requires_grad=requires_grad))


def _close(got, want, tol, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale if got.size else 0.0
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def _close_tree(got, want, tol, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], tol, f"{path}{k}.")
        else:
            _close(got[k], want[k], tol, f"{path}{k}")


# (id, variant, mode, m, cfg overrides)
CASES = [
    ("tc-train-gs1", "tokens_choice", "train", M,
     dict(group_size=1, bpr=False)),
    ("tc-train-gs2-bpr", "tokens_choice", "train", M,
     dict(group_size=2, bpr=True)),
    ("tc-train-gs2-nobpr", "tokens_choice", "train", M,
     dict(group_size=2, bpr=False)),
    ("tc-tight-bpr", "tokens_choice", "train", M,
     dict(group_size=2, bpr=True, capacity_factor=0.5)),
    ("tc-tight", "tokens_choice", "train", M,
     dict(group_size=1, bpr=False, capacity_factor=0.5)),
    ("tc-shared2", "tokens_choice", "train", M,
     dict(num_shared_experts=2, bpr=False)),
    ("tc-ties", "tokens_choice", "train", M,
     dict(group_size=2, bpr=True, capacity_factor=0.5)),
    ("tc-prefill", "tokens_choice", "prefill", M,
     dict(group_size=4, bpr=True, capacity_factor=0.5)),
    ("tc-decode", "tokens_choice", "decode", 1,
     dict(group_size=4, bpr=True, capacity_factor=0.5)),
    ("tc-hatch", "tokens_choice", "decode", M,
     dict(group_size=4, bpr=True, capacity_factor=0.5, batch_coupled=True)),
    ("ec-train-gs1", "experts_choice", "train", M, dict(group_size=1)),
    ("ec-tight-gs2", "experts_choice", "train", M,
     dict(group_size=2, capacity_factor=0.5)),
    ("ec-ties", "experts_choice", "train", M,
     dict(group_size=2, capacity_factor=0.5)),
    ("ec-prefill", "experts_choice", "prefill", M,
     dict(group_size=4, capacity_factor=0.5)),
    ("ec-hatch", "experts_choice", "prefill", M,
     dict(group_size=2, capacity_factor=0.5, batch_coupled=True)),
]

_REF = {}


def _case(jx, cid):
    """(jax cfg, port cfg, mode, jax params, x (numpy), cotangent, JAX
    (y, metrics, grads)); the JAX side computed once per module."""
    if cid in _REF:
        return _REF[cid]
    _, variant, mode, m, over = next(c for c in CASES if c[0] == cid)
    kw = dict(variant=variant, num_experts=E, expert_d_ff=DFF, top_k=2,
              **over)
    jcfg, tcfg = jx.MoEConfig(**kw), MoEConfig(**kw)
    rng = np.random.RandomState([c[0] for c in CASES].index(cid))
    params = jx.sparse.sparse_moe_init(jx.jax.random.PRNGKey(1), D, jcfg)
    if cid.endswith("ties"):  # every router score equal: order by index
        params["router"] = jx.jnp.zeros_like(params["router"])
    x = rng.randn(B, m, D).astype(np.float32)
    cot = rng.randn(B, m, D).astype(np.float32)
    apply = (jx.sparse.tokens_choice_apply if variant == "tokens_choice"
             else jx.sparse.experts_choice_apply)

    def loss(p, xx):
        y, met = apply(p, jcfg, xx, telemetry=True, mode=mode)
        return jx.jnp.sum(y * cot) + met["moe_aux_loss"], (y, met)

    (_, (y, met)), grads = jx.jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    _REF[cid] = (jcfg, tcfg, mode, params, x, cot,
                 (np.asarray(y), _np_tree(met),
                  (_np_tree(grads[0]), np.asarray(grads[1]))))
    return _REF[cid]


def _port(jx, cid):
    jcfg, tcfg, mode, params, x, cot, ref = _case(jx, cid)
    tparams = _torch_tree(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, met = moe_apply(tparams, tcfg, tx, telemetry=True, mode=mode)
    (torch.sum(y * torch.from_numpy(cot)) + met["moe_aux_loss"]).backward()
    return tparams, tx, y, met, ref


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_sparse_layer_matches_jax(jx, cid):
    tparams, tx, y, met, (y_ref, met_ref, (gp_ref, gx_ref)) = _port(jx, cid)
    _close(y, y_ref, FWD_TOL, "y")
    _close(met["moe_aux_loss"], met_ref["moe_aux_loss"], FWD_TOL, "aux")
    _close(met["dropped_fraction"], met_ref["dropped_fraction"], FWD_TOL,
           "dropped_fraction")
    _close_tree(met["telemetry"], met_ref["telemetry"], FWD_TOL)
    for leaf in _leaves(met["telemetry"]):
        assert leaf.dtype == torch.float32 and not leaf.requires_grad
    _close(tx.grad, gx_ref, GRAD_TOL, "dx")
    _close(tparams["router"].grad, gp_ref["router"], GRAD_TOL, "d router")
    for k in gp_ref["experts"]:
        _close(tparams["experts"][k].grad, gp_ref["experts"][k], GRAD_TOL,
               f"d experts.{k}")
    if "shared" in gp_ref:
        for k in gp_ref["shared"]:
            _close(tparams["shared"][k].grad, gp_ref["shared"][k], GRAD_TOL,
                   f"d shared.{k}")


def _np_tokens_choice_keep(expert_index, gate0, capacity, bpr):
    """Loop oracle of Tokens Choice's drops: per group, tokens in
    priority order (BPR: max gate descending, ties by position), each
    choice kept while its expert has room."""
    g, t, k = expert_index.shape
    keep = np.zeros((g, t, k), bool)
    for gi in range(g):
        order = (sorted(range(t), key=lambda i: -gate0[gi, i]) if bpr
                 else range(t))
        used = {}
        for i in order:
            for j in range(k):
                ex = int(expert_index[gi, i, j])
                keep[gi, i, j] = used.get(ex, 0) < capacity
                used[ex] = used.get(ex, 0) + 1
    return keep


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_routing_decisions_equal_jax(jx, cid):
    """The experts each token picks (Tokens Choice) or the tokens each
    expert picks (Experts Choice) equal JAX's ``top_k``; Tokens Choice's
    kept choices equal a loop oracle. The tight cases must drop a choice
    of an expert whose last slot holds a kept token (the spare-row
    dispatch keeps that token)."""
    jcfg, tcfg, mode, params, x, _, _ = _case(jx, cid)
    b, m, _ = x.shape
    coupled, gs = sparse_moe._routing_scope(tcfg, mode, b, m)
    xg = x.reshape(b // gs, gs * m, D)
    jprobs = jx.jax.nn.softmax(jx.sparse._router_logits(params, xg),
                               axis=-1)
    probs = torch.softmax(sparse_moe._router_logits(
        _torch_tree(params), torch.from_numpy(xg)), dim=-1)
    _close(probs, jprobs, FWD_TOL, "router probs")
    if tcfg.variant == "experts_choice":
        t = gs * m
        cap = max(int(tcfg.capacity_factor * t / E), 1) if coupled else t
        _, tidx = sparse_moe._top_k(probs.transpose(1, 2), cap)
        _, jtidx = jx.jax.lax.top_k(jx.jnp.swapaxes(jprobs, 1, 2), cap)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jtidx))
        return
    gate_n, eidx, pos, keep, cap = sparse_moe._tokens_choice_route(
        probs, tcfg, coupled)
    jgate, jeidx = jx.jax.lax.top_k(jprobs, tcfg.top_k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    want = _np_tokens_choice_keep(np.asarray(jeidx), np.asarray(jgate)[..., 0],
                                  cap, tcfg.bpr and coupled)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert (pos[keep] < cap).all()
    if "tight" in cid:
        full = (pos == cap - 1) & keep  # an expert's last slot, kept
        last = {(int(gi), int(eidx[gi, i, j])) for gi, i, j in full.nonzero()}
        drops = {(int(gi), int(eidx[gi, i, j]))
                 for gi, i, j in (~keep).nonzero()}
        assert last & drops, "no drop landed on a kept last slot"
    if not coupled:
        assert keep.all()


@pytest.mark.parametrize("variant", ["tokens_choice", "experts_choice"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_row_alone_equals_row_in_batch(variant, mode):
    """Per-row dropless routing: a row's output and its telemetry rows do
    not depend on the rows beside it, even with group/capacity/BPR knobs
    that bind in train mode (within 1e-6 inside the port)."""
    cfg = MoEConfig(variant=variant, num_experts=E, expert_d_ff=DFF,
                    top_k=2, group_size=4, capacity_factor=0.5, bpr=True)
    params = moe_init(torch.Generator().manual_seed(0), D, cfg)
    m = 1 if mode == "decode" else M
    x = torch.from_numpy(np.random.RandomState(3).randn(B, m, D)
                         .astype(np.float32))
    with torch.no_grad():
        yb, mb = moe_apply(params, cfg, x, telemetry=True, mode=mode)
        for i in range(B):
            y1, m1 = moe_apply(params, cfg, x[i:i + 1], telemetry=True,
                               mode=mode)
            assert (y1[0] - yb[i]).abs().max() <= 1e-6
            for k, v in m1["telemetry"]["rows"].items():
                assert abs(float(v[0]) - float(mb["telemetry"]["rows"][k][i])
                           ) <= 1e-6, k
    assert float(mb["dropped_fraction"]) == 0.0


ABLATIONS = ["identity", "uniform", "soft_uniform", "uniform_soft"]


@pytest.mark.parametrize("variant", ABLATIONS)
def test_ablation_matches_jax(jx, variant):
    """Forward and gradients (x, phi, scale, experts) against
    ``ablation_apply``, at m != n p (m = 8 tokens, 3 experts x 2 slots)."""
    kw = dict(variant=variant, num_experts=3, slots_per_expert=2,
              expert_d_ff=DFF)
    jcfg, tcfg = jx.MoEConfig(**kw), MoEConfig(**kw)
    rng = np.random.RandomState(7)
    params = jx.ablation_init(jx.jax.random.PRNGKey(2), D, jcfg)
    x = rng.randn(B, M, D).astype(np.float32)
    cot = rng.randn(B, M, D).astype(np.float32)

    def loss(p, xx):
        y, met = jx.ablation_apply(p, jcfg, xx)
        return jx.jnp.sum(y * cot) + met["moe_aux_loss"], y

    (_, y_ref), (gp, gx) = jx.jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    tparams = _torch_tree(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, met = moe_apply(tparams, tcfg, tx, telemetry=True, mode="decode")
    assert set(met) == {"moe_aux_loss"} and float(met["moe_aux_loss"]) == 0
    (torch.sum(y * torch.from_numpy(cot)) + met["moe_aux_loss"]).backward()
    _close(y, y_ref, FWD_TOL, "y")
    _close(tx.grad, gx, GRAD_TOL, "dx")
    for k in gp["experts"]:
        _close(tparams["experts"][k].grad, gp["experts"][k], GRAD_TOL, k)
    for k in ("phi", "scale"):
        if variant in ("soft_uniform", "uniform_soft"):
            _close(tparams[k].grad, gp[k], GRAD_TOL, k)
        else:
            assert tparams[k].grad is None or not tparams[k].grad.any()
    # the port's own init gives Soft MoE's structure
    own = moe_init(torch.Generator().manual_seed(0), D, tcfg)
    assert set(own) == set(params) and set(own["experts"]) == set(
        params["experts"])
    ablation_apply(own, tcfg, torch.from_numpy(x))


def test_sparse_init_structure_matches_jax(jx):
    """``moe_init`` of the sparse variants gives the JAX tree's keys,
    shapes and f32 dtype (router, experts, shared)."""
    for variant in ("tokens_choice", "experts_choice"):
        kw = dict(variant=variant, num_experts=E, expert_d_ff=DFF,
                  num_shared_experts=2)
        ref = _np_tree(jx.sparse.sparse_moe_init(
            jx.jax.random.PRNGKey(0), D, jx.MoEConfig(**kw)))
        own = moe_init(torch.Generator().manual_seed(0), D, MoEConfig(**kw))
        assert _map(ref, lambda a: a.shape) == _map(
            own, lambda t: tuple(t.shape))
        assert all(t.dtype == torch.float32 for t in _leaves(own))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch sees none)")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tokens_choice", "experts_choice"])
def test_sparse_layer_on_the_card_matches_cpu_and_repeats_bitwise(
        card, variant):
    """On the card in f32: the layer agrees with the same layer on the
    CPU (routes equal, y within 1e-5, gradients within 1e-4), and two
    runs give the same bits, forward and backward (no atomics race)."""
    cfg = MoEConfig(variant=variant, num_experts=32, expert_d_ff=64,
                    top_k=8, capacity_factor=1.0, group_size=2, bpr=True)
    params = moe_init(torch.Generator().manual_seed(0), 128, cfg)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 256, 128)
                         .astype(np.float32))
    runs = []
    for dev in ("cpu", "cuda", "cuda"):
        p = _map(params, lambda t: t.detach().to(dev).requires_grad_())
        xx = x.detach().to(dev).requires_grad_()
        y, met = moe_apply(p, cfg, xx, telemetry=True)
        (y.square().sum() + met["moe_aux_loss"]).backward()
        runs.append([t.detach().cpu() for t in
                     (y, met["moe_aux_loss"], xx.grad,
                      *(v.grad for v in _leaves(p)))])
    cpu, a, b = runs
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    _close(a[0], cpu[0].numpy(), FWD_TOL, "y card vs cpu")
    _close(a[1], cpu[1].numpy(), FWD_TOL, "aux card vs cpu")
    for u, v in zip(a[2:], cpu[2:]):
        _close(u, v.numpy(), GRAD_TOL, "grad card vs cpu")
