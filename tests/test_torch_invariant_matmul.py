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
- malformed operands raise and launch nothing;
- the launch plan (``_plan``): the fields that fix the order of the sums
  (k step, k tile, chunk width and count, merge) are the same for every
  M and n at a given K, whatever the tile, the layout or the split; a
  split cluster's chunk merge gives the bits of one CTA's running total;
  operands are made unit-strided only where they have no unit stride.

The ``cuda``-marked tests hold the kernel against its plain version on
the card (within 1e-6 of max|ref|) with every row (every matrix) of
every launch bitwise its 1-row (1-matrix) launch, at row and matrix
counts on both sides of each tile and split boundary of the plan, on
the main path's four layouts (the router weight, the transposed key
view, the latent values, ``w_uv``'s strided views) and on misaligned
operands; they skip here. The JAX reference is imported by the
``jx`` fixture, so that the file also collects on a GPU machine without
jax."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.core import moe_apply, moe_init
from repro_torch.core import sparse_moe
from repro_torch.kernels import invariant_matmul as im
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


PLAN_COUNTS = (1, 7, 8, 9, 64, 255, 256, 2048, 16384)
ORDER_FIELDS = ("k_step", "k_tile", "k_chunk", "n_chunks", "merge")


def _layouts(P, K, Q):
    """(a strides, b strides) of the main path's layouts for one matrix
    of an (n, P, K) x (n, K, Q) product: the router weight and the
    latent values (b q-unit-stride), the transposed key view (b
    k-unit-stride), ``w_uv``'s strided views (a (H, B S, r) and b (H, r,
    Dv) out of (B S, H, r) and (r, H, Dv) with H = 16)."""
    return {"q-fast": ((P * K, K, 1), (K * Q, Q, 1)),
            "k-fast": ((P * K, K, 1), (K * Q, 1, K)),
            "w_uv": ((K, 16 * K, 1), (Q, 16 * Q, 1))}


@pytest.mark.parametrize("K", [0, 1, 40, 255, 256, 257, 512, 576, 1024,
                               2048, 2049, 4096])
def test_plan_k_order_depends_on_k_alone(K):
    orders, splits = set(), set()
    for Q in (5, 32, 64, 512, 2048):
        for count in PLAN_COUNTS:
            for n, P in ((1, count), (count, 16)):  # rows, or matrices
                for name, (sa, sb) in _layouts(P, K, Q).items():
                    plan = im._plan(n, P, K, Q, sa, sb)
                    orders.add(tuple(getattr(plan, f) for f in ORDER_FIELDS))
                    splits.add(plan.n_split)
                    # b's unit q stride decides (a k-fast view of one
                    # k is also q-fast)
                    assert plan.b_k_fast == (Q > 1 and sb[2] != 1)
                    assert plan.n_split in (1, plan.n_chunks)
                    assert plan.n_split <= im.MAX_SPLIT
                    assert plan.tile == (
                        0 if P <= 256 else 1 if P >= 4096 and Q >= 128
                        else 2)
                    bm, bn = im.TILES[plan.tile]
                    assert plan.grid == (-(-Q // bn) * plan.n_split,
                                         -(-P // bm), n)
    assert orders == {(8, 32, 256, max(1, -(-K // 256)),
                       "chunk order from 0")}
    # a K of several chunks (at most a cluster's) splits on small grids
    # and not on large ones; any other K never does
    assert splits == ({1, -(-K // 256)} if 256 < K <= 2048 else {1})


def test_plan_copy_width_follows_alignment():
    sa, sb = (40 * 7, 40, 1), (40 * 5, 5, 1)  # d 40, e 5
    plan = im._plan(1, 7, 40, 5, sa, sb)
    assert (plan.vec_a, plan.vec_b) == (True, False)  # e = 5: 4-byte B
    plan = im._plan(1, 7, 40, 8, sa, (320, 8, 1), False)
    assert (plan.vec_a, plan.vec_b) == (False, True)  # a misaligned base
    plan = im._plan(2, 7, 42, 8, (7 * 42, 42, 1), (42 * 8, 8, 1))
    assert (plan.vec_a, plan.vec_b) == (False, True)  # K % 4 != 0
    plan = im._plan(3, 16, 576, 2048, (16 * 576, 576, 1),
                    (576 * 2048, 1, 576))
    assert plan.b_k_fast and plan.vec_a and plan.vec_b


def test_split_merge_is_the_running_total_bitwise():
    """A split cluster adds its chunks' sums (each 0 + its chunk) in
    chunk order from 0; one CTA adds the chunk sums into its total from
    0: the same bits, signed zeros and infinities included."""
    rng = np.random.RandomState(5)
    vals = np.concatenate([rng.randn(4000) * 10.0 ** rng.randint(
        -30, 30, 4000), [0.0, -0.0, np.inf, -np.inf, 1e38, -1e38]])
    chunks = rng.choice(vals, size=(20000, 8)).astype(np.float32)
    zero = np.float32(0)
    with np.errstate(invalid="ignore", over="ignore"):
        total = np.zeros(len(chunks), np.float32)
        merged = np.zeros(len(chunks), np.float32)
        for c in range(chunks.shape[1]):
            total = total + chunks[:, c]
            merged = merged + (zero + chunks[:, c])
    same = (total.view(np.uint32) == merged.view(np.uint32)) | (
        np.isnan(total) & np.isnan(merged))
    assert same.all()


def test_unit_strided_copies_only_operands_without_a_unit_stride():
    a = torch.randn(2, 5, 8)
    b = torch.randn(2, 8, 3)
    kt = torch.randn(2, 3, 8).transpose(1, 2)  # the key view: k-fast
    for x, y in ((a, b), (a, kt), (a[:, :, :1], b[:, :1])):
        xa, yb = im._unit_strided(x, y)
        assert xa is x and yb is y
    at = a.transpose(1, 2).contiguous().transpose(1, 2)
    bs = torch.randn(2, 16, 6)[:, ::2, ::2]  # no unit stride
    xa, yb = im._unit_strided(at, bs)
    assert at.stride(2) != 1 and xa.stride(2) == 1 and yb.is_contiguous()
    assert torch.equal(xa, a) and torch.equal(yb, bs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _every_row_bitwise(fn, counts, label):
    """``fn(0, m)`` (the launch of rows, or matrices, [0, m)) for every
    m in ``counts`` against ``fn(i, i + 1)``, every row bitwise."""
    solo = torch.cat([fn(i, i + 1) for i in range(max(counts))])
    for m in counts:
        out = fn(0, m)
        torch.cuda.synchronize()
        assert torch.equal(out, solo[:m]), (label, m)
    return solo


@pytest.mark.cuda
@pytest.mark.parametrize("d,e", [(1024, 32), (2048, 64), (40, 5)])
def test_cuda_router_logits_rows_invariant_and_close(cuda, d, e):
    gen = torch.Generator(device=cuda).manual_seed(d)
    w = torch.randn(d, e, generator=gen, device=cuda) / d ** 0.5
    # tile 0 (16 rows) up to 256 rows, then tile 2 (64 rows), whose grid
    # splits into chunks (d > 256) up to 131 tiles (8384 rows), not at 132
    counts = (1, 7, 8, 9, 16, 17, 255, 256, 257, 300, 2048, 8384, 8385,
              16384, 16769)
    x = torch.randn(max(counts), 1, d, generator=gen, device=cuda)
    for m in (1, 4, 8, 37, 300, 16769):
        before = router_logits.launches
        out = router_logits(x[:m], w)
        torch.cuda.synchronize()
        assert router_logits.launches == before + 1
        # cuBLAS's own f32 error at 16769 rows exceeds 1e-6 of max|ref|
        # (a 1024-long chain): hold that count against the f64 product
        want = (router_logits_ref(x[:m], w) if m <= 300 else
                router_logits_ref(x[:m].double(), w.double()))
        err = (out.double() - want).abs().max().item()
        assert err <= PLAIN_TOL * want.abs().max().item(), (m, err)
    solo = _every_row_bitwise(lambda lo, hi: router_logits(x[lo:hi], w),
                              counts, f"router d {d} e {e}")
    # a misaligned base (4-byte copies) gives the same bits
    xm = torch.randn(300, 1, d + 1, generator=gen, device=cuda)
    xm[..., 1:] = x[:300]
    assert im._plan(1, 300, d, e, (0, d + 1, 1), (0, e, 1),
                    xm[..., 1:].data_ptr() % 16 == 0).vec_a is False
    assert torch.equal(router_logits(xm[..., 1:], w), solo[:300])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 2048])
def test_cuda_batched_contract_matrices_invariant_and_close(cuda, t):
    gen = torch.Generator(device=cuda).manual_seed(t)
    # scores: 32 key tiles a matrix at 2048 keys, so 4 matrices split
    # into chunks and 5 do not; values: 8 latent tiles, 16 and 17
    counts = (1, 4, 5, 8, 16, 17, 33)
    n = max(counts)
    q = torch.randn(n, 16, 576, generator=gen, device=cuda)
    k = torch.randn(n, t, 576, generator=gen, device=cuda)
    p = torch.softmax(torch.randn(n, 16, t, generator=gen, device=cuda), -1)
    for kind, (a, b) in (("scores", (q, k.transpose(1, 2))),
                         ("values", (p, k[..., :512]))):
        # against the f64 product: on these f32 (not bf16-valued) scores
        # cuBLAS's own f32 error is ~1e-6 of max|ref| at 8 matrices of
        # 2048 keys (PERF.md §6), so the plain einsum cannot judge
        # the kernel there
        one = batched_contract(a[:1], b[:1])
        for m in (1, 4, 8, n):
            out = batched_contract(a[:m], b[:m])
            torch.cuda.synchronize()
            want = batched_contract_ref(a[:m].double(), b[:m].double())
            err = (out.double() - want).abs().max().item()
            assert err <= PLAIN_TOL * want.abs().max().item(), (kind, m, err)
            assert torch.equal(out[:1], one), (kind, m)
        _every_row_bitwise(
            lambda lo, hi: batched_contract(a[lo:hi], b[lo:hi]), counts,
            f"{kind} matrices")
    # the layout moves no sum: the k-fast key view and its q-fast copy
    kt = k.transpose(1, 2)
    assert torch.equal(batched_contract(q, kt),
                       batched_contract(q, kt.contiguous()))


@pytest.mark.cuda
def test_cuda_batched_contract_prefill_rows_invariant(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    keys = torch.randn(1, 2048, 576, generator=gen, device=cuda)
    rows = torch.randn(4096, 1, 576, generator=gen, device=cuda)
    w = torch.softmax(torch.randn(4096, 1, 2048, generator=gen,
                                  device=cuda), -1)
    # tile 0 up to 256 rows (split while under 132 tiles), tile 2 from
    # 257, tile 1 from 4096
    counts = (1, 16, 17, 128, 129, 256, 257, 4095, 4096)
    for kind, a, b in (("scores", rows, keys.transpose(1, 2)),
                       ("values", w, keys[..., :512])):
        a = a.transpose(0, 1)  # (1, rows, k)
        # against f64, as phase 6b holds prefill: at 4096 rows cuBLAS's
        # own f32 error exceeds 1e-6 of max|ref|
        out = batched_contract(a, b).double()
        want = batched_contract_ref(a.double(), b.double())
        err = (out - want).abs().max().item()
        assert err <= PLAIN_TOL * want.abs().max().item(), (kind, err)
        _every_row_bitwise(lambda lo, hi: batched_contract(a[:, lo:hi], b)[0],
                           counts, f"prefill {kind}")


@pytest.mark.cuda
def test_cuda_w_uv_strided_views_rows_invariant(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    h, r, dv = 16, 512, 128
    w_uv = torch.randn(r, h, dv, generator=gen, device=cuda)
    lat = torch.randn(300, h, r, generator=gen, device=cuda)

    def up(lo, hi):  # _latent_up's views: (H, rows, r) x (H, r, Dv)
        a, b = lat[lo:hi].transpose(0, 1), w_uv.permute(1, 0, 2)
        assert a.stride() == (r, h * r, 1) and b.stride() == (dv, h * dv, 1)
        return batched_contract(a, b).transpose(0, 1)

    out = up(0, len(lat))
    want = torch.einsum("shr,rhv->shv", lat, w_uv)
    err = (out - want).abs().max().item()
    assert err <= PLAIN_TOL * want.abs().max().item(), err
    _every_row_bitwise(up, (1, 8, 16, 17, 129, 300), "w_uv")


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
