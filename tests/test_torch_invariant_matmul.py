"""The fixed-order f32 contraction (``kernels/invariant_matmul.py``) and
the products routed through it, against the JAX package on the same
numpy inputs, in f32:

- the plain ``router_logits`` against the JAX ``core.sparse_moe.
  _router_logits`` (within 1e-6 of max|ref|), and the gradients of the
  port's ``_router_logits`` (its autograd Function: the kernel forward,
  the plain products backward) against ``jax.grad`` of the same (1e-5);
- MLA's serving products: ``_attend`` with one KV group and a mask
  (its products through ``_f32_contract``: the fixed-order contraction
  without gradients, ``torch.bmm`` with) against the JAX ``_attend``,
  ``_latent_up`` against the reference's ``w_uv`` einsum (1e-5), and
  ``mla_apply`` routing each of its three products through
  ``batched_contract`` exactly when none of its operands needs a
  gradient;
- ``batch_coupled`` serving equal to ``mode="train"`` bitwise, both
  variants;
- malformed operands raise and launch nothing.

The ``cuda``-marked tests hold the kernel against its plain version on
the card (within 1e-6 of max|ref|) with row 0 of every launch bitwise the
1-row launch; they skip here. The JAX reference is imported by the
``jx`` fixture, so that the file also collects on a GPU machine without
jax."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.core import moe_apply, moe_init
from repro_torch.core import sparse_moe
from repro_torch.kernels.invariant_matmul import (
    batched_contract,
    batched_contract_ref,
    router_logits,
    router_logits_ref,
)
from repro_torch.layers import attention as tattn

PLAIN_TOL, GRAD_TOL, MLA_TOL = 1e-6, 1e-5, 1e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import sparse_moe as jsparse
    from repro.layers import attention as jattn

    return types.SimpleNamespace(jax=jax, jnp=jnp, sparse=jsparse,
                                 attn=jattn)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")


def _close(got, want, tol, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, (what, err, scale)


def _router_case(seed, g, t, d, e):
    rng = np.random.RandomState(seed)
    x = rng.randn(g, t, d).astype(np.float32)
    w = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("g,t,d,e", [(2, 5, 48, 8), (1, 1, 64, 6),
                                     (3, 7, 33, 4)])
def test_plain_router_logits_matches_jax(jx, g, t, d, e):
    x, w = _router_case(g * 100 + t, g, t, d, e)
    want = jx.sparse._router_logits({"router": jx.jnp.asarray(w)},
                                    jx.jnp.asarray(x))
    got = router_logits(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (g, t, e) and got.dtype == torch.float32
    _close(got, want, PLAIN_TOL, "logits")
    # the layer's entry widens a bf16 input and weight first
    bf = torch.from_numpy(x).bfloat16()
    got = sparse_moe._router_logits({"router": torch.from_numpy(w)}, bf)
    want = jx.sparse._router_logits({"router": jx.jnp.asarray(w)},
                                    jx.jnp.asarray(bf.float().numpy()))
    _close(got, want, PLAIN_TOL, "logits of a bf16 input")


def test_router_logits_gradient_matches_jax_grad(jx):
    x, w = _router_case(7, 2, 6, 40, 8)
    cot = np.random.RandomState(8).randn(2, 6, 8).astype(np.float32)

    def loss(xx, ww):
        out = jx.sparse._router_logits({"router": ww}, xx)
        return jx.jnp.sum(out * cot)

    gx_ref, gw_ref = jx.jax.grad(loss, argnums=(0, 1))(
        jx.jnp.asarray(x), jx.jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = sparse_moe._router_logits({"router": tw}, tx)
    assert out.grad_fn is not None and "RouterLogits" in out.grad_fn.name()
    (out * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, gx_ref, GRAD_TOL, "dx")
    _close(tw.grad, gw_ref, GRAD_TOL, "dw")
    # only the input that needs a gradient gets one
    tw2 = torch.tensor(w, requires_grad=True)
    router_logits(torch.from_numpy(x), tw2).sum().backward()
    _close(tw2.grad, jx.jax.grad(
        lambda ww: jx.jnp.sum(jx.sparse._router_logits(
            {"router": ww}, jx.jnp.asarray(x))))(jx.jnp.asarray(w)),
        GRAD_TOL, "dw alone")


def _latent_case(seed, b=3, sq=2, h=4, r=16, rope=8, sk=12, dv=5):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, r + rope).astype(np.float32)
    k = rng.randn(b, sk, 1, r + rope).astype(np.float32)
    mask = rng.rand(b, sq, sk) > 0.3
    mask[:, :, 0] = True
    lat = rng.randn(b, sq, h, r).astype(np.float32)
    w_uv = rng.randn(r, h, dv).astype(np.float32)
    return q, k, mask, lat, w_uv


def test_mla_serving_products_match_jax(jx):
    q, k, mask, lat, w_uv = _latent_case(11)
    r = lat.shape[-1]
    scale = 0.17
    want = jx.attn._attend(jx.jnp.asarray(q), jx.jnp.asarray(k),
                           jx.jnp.asarray(k[..., :r]),
                           jx.jnp.asarray(mask), scale=scale)
    tq, tk, tmask = map(torch.from_numpy, (q, k, mask))
    got = tattn._attend(tq, tk, tk[..., :r], tmask, scale=scale)
    _close(got, want, MLA_TOL, "attend over the latent")
    # the training path (torch.bmm) gives the same numbers
    trained = tattn._attend(tq.clone().requires_grad_(), tk, tk[..., :r],
                            tmask, scale=scale)
    assert trained.grad_fn is not None
    _close(got, trained.detach().numpy(), MLA_TOL, "served vs trained")
    want = jx.jnp.einsum("bshr,rhv->bshv", jx.jnp.asarray(lat),
                         jx.jnp.asarray(w_uv))
    got = tattn._latent_up(torch.from_numpy(lat), torch.from_numpy(w_uv))
    _close(got, want, MLA_TOL, "w_uv expansion")


def test_mla_takes_the_contraction_only_without_gradients(monkeypatch):
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    params = tattn.mla_init(torch.Generator().manual_seed(0), cfg)
    calls = []

    def counted(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return batched_contract(a, b)

    monkeypatch.setattr(tattn, "batched_contract", counted)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    served, _ = tattn.mla_apply(params, cfg, x)
    assert len(calls) == 3  # the scores, the weighted latent, w_uv
    trained_params = {k: v.clone().requires_grad_() for k, v in
                      params.items()}
    trained, _ = tattn.mla_apply(trained_params, cfg, x)
    assert len(calls) == 3  # training takes torch.bmm
    trained.sum().backward()
    _close(served, trained.detach().numpy(), MLA_TOL, "served vs trained")
    # w_uv alone trained: its expansion takes torch.bmm, the scores and
    # the weighted latent (no operand needs a gradient) the contraction
    only_uv = dict(params, w_uv=params["w_uv"].clone().requires_grad_())
    out, _ = tattn.mla_apply(only_uv, cfg, x)
    assert calls[3:] == calls[:2]
    out.sum().backward()
    assert only_uv["w_uv"].grad is not None
    _close(out.detach(), served.numpy(), MLA_TOL, "w_uv trained vs served")


@pytest.mark.parametrize("variant,mode", [("tokens_choice", "decode"),
                                          ("tokens_choice", "prefill"),
                                          ("experts_choice", "prefill")])
def test_batch_coupled_serving_equals_train_bitwise(variant, mode):
    cfg = MoEConfig(variant=variant, num_experts=4, expert_d_ff=16, top_k=2,
                    group_size=2, capacity_factor=0.5, bpr=True,
                    batch_coupled=True)
    gen = torch.Generator().manual_seed(3)
    params = moe_init(gen, 16, cfg)
    x = torch.randn(4, 1 if mode == "decode" else 6, 16, generator=gen)
    y_s, met_s = moe_apply(params, cfg, x, telemetry=True, mode=mode)
    y_t, met_t = moe_apply(params, cfg, x, telemetry=True, mode="train")
    assert torch.equal(y_s, y_t)
    assert torch.equal(met_s["moe_aux_loss"], met_t["moe_aux_loss"])
    assert torch.equal(met_s["dropped_fraction"], met_t["dropped_fraction"])


@pytest.mark.parametrize("call,exc", [
    (lambda x, w, a, b: router_logits(x.bfloat16(), w), TypeError),
    (lambda x, w, a, b: router_logits(x, w.double()), TypeError),
    (lambda x, w, a, b: router_logits(x, w[0]), ValueError),
    (lambda x, w, a, b: router_logits(x[..., :-1], w), ValueError),
    (lambda x, w, a, b: batched_contract(a.half(), b), TypeError),
    (lambda x, w, a, b: batched_contract(a[0], b[0]), ValueError),
    (lambda x, w, a, b: batched_contract(a, b[:, :-1]), ValueError),
    (lambda x, w, a, b: batched_contract(a[:1], b), ValueError),
    (lambda x, w, a, b: batched_contract(a.clone().requires_grad_(), b),
     ValueError),
])
def test_malformed_operands_raise(call, exc):
    x, w = (torch.from_numpy(t) for t in _router_case(1, 2, 3, 8, 4))
    a, b = torch.randn(2, 3, 8), torch.randn(2, 8, 5)
    before = (router_logits.launches, batched_contract.launches)
    with pytest.raises(exc):
        call(x, w, a, b)
    assert (router_logits.launches, batched_contract.launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d,e", [(1024, 32), (2048, 64), (40, 5)])
def test_cuda_router_logits_rows_invariant_and_close(cuda, d, e):
    gen = torch.Generator(device=cuda).manual_seed(d)
    w = torch.randn(d, e, generator=gen, device=cuda) / d ** 0.5
    x = torch.randn(300, 1, d, generator=gen, device=cuda)
    one = router_logits(x[:1], w)
    for m in (1, 4, 8, 37, 300):
        before = router_logits.launches
        out = router_logits(x[:m], w)
        torch.cuda.synchronize()
        assert router_logits.launches == before + 1
        want = router_logits_ref(x[:m], w)
        err = (out - want).abs().max().item()
        assert err <= PLAIN_TOL * want.abs().max().item(), (m, err)
        assert torch.equal(out[:1], one), m
        assert torch.equal(out[m - 1:m], router_logits(x[m - 1:m], w)), m


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 2048])
def test_cuda_batched_contract_matrices_invariant_and_close(cuda, t):
    gen = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn(8, 16, 576, generator=gen, device=cuda)
    k = torch.randn(8, t, 576, generator=gen, device=cuda)
    p = torch.softmax(torch.randn(8, 16, t, generator=gen, device=cuda), -1)
    for a, b in ((q, k.transpose(1, 2)), (p, k[..., :512])):
        one = batched_contract(a[:1], b[:1])
        for n in (1, 4, 8):
            out = batched_contract(a[:n], b[:n])
            torch.cuda.synchronize()
            want = batched_contract_ref(a[:n], b[:n])
            err = (out - want).abs().max().item()
            assert err <= PLAIN_TOL * want.abs().max().item(), (n, err)
            assert torch.equal(out[:1], one), n


@pytest.mark.cuda
def test_cuda_router_gradient_is_the_plain_products(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(64, 8, 256, generator=gen, device=cuda,
                    requires_grad=True)
    w = torch.randn(256, 16, generator=gen, device=cuda, requires_grad=True)
    g = torch.randn(64, 8, 16, generator=gen, device=cuda)
    before = router_logits.launches
    (router_logits(x, w) * g).sum().backward()
    assert router_logits.launches == before + 1
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (router_logits_ref(x, w) * g).sum().backward()
    for got, want in ((gx, x.grad), (gw, w.grad)):
        err = (got - want).abs().max().item()
        assert err <= GRAD_TOL * want.abs().max().item()
