"""The port's chunked attention and MLA layer against the JAX package on
the same numpy inputs, in f32:

- ``_attend_chunked`` against the JAX ``_attend_chunked`` (forward and
  the gradients of q, k and v) and against the JAX ``_attend``, causal
  and not, window None and 16, block 16 (the cases of
  ``tests/test_layers.py``), a ragged key count that pads the last block,
  a row with no valid key (where the padding counts, as in the
  reference) and MLA's value width below the key width; within 2e-5, the
  reference's own tolerance;
- one MLA layer of reduced ``deepseek-v2-lite-16b`` (``mla_apply``) with
  no cache within 1e-5, through a paged chunked prefill (one row
  left-padded) then decode steps with the latent pool (``ckv``,
  ``krope``, ``pos``) equal to the JAX pool, its gradients within 1e-4,
  and on the chunked path (the threshold lowered in both packages);
- the MLA pool's copy-on-write fork and block reset against JAX, and
  ``serving_params`` keeping ``w_uk`` and ``w_uv`` in f32.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.layers import attention as tattn
from repro_torch.serve.engine import serving_params

ARCH = "deepseek-v2-lite-16b"
CHUNK_TOL = 2e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.layers import attention as jattn

    cfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="float32")
    params = jax.jit(lambda key: jattn.mla_init(key, cfg))(
        jax.random.PRNGKey(3))
    return types.SimpleNamespace(jax=jax, jnp=jnp, attn=jattn, cfg=cfg,
                                 params=params)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the chunked attention ---------------------------------------------------


def _case(seed, b, sq, sk, h, g, d, dv):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, dv),
                          (b, sq, h, dv))]


CHUNK_CASES = {
    # label: (b, sq, sk, h, g, d, dv, causal, window, scale, block)
    **{f"causal={c}-window={w}": (2, 64, 64, 8, 2, 32, 32, c, w, None, 16)
       for c in (True, False) for w in (None, 16)},
    "ragged-sk": (2, 24, 40, 4, 2, 16, 16, True, None, None, 16),
    "mla-dv<dk": (1, 16, 16, 4, 1, 24, 8, True, None, 0.3, 4),
}


@pytest.mark.parametrize("label", list(CHUNK_CASES))
def test_chunked_attention_matches_jax(jx, label):
    """Forward and the q, k, v gradients of a random cotangent against the
    JAX chunked path; the forward also against the JAX dense path."""
    b, sq, sk, h, g, d, dv, causal, window, scale, block = \
        CHUNK_CASES[label]
    q, k, v, ct = _case(0, b, sq, sk, h, g, d, dv)
    # queries at the end of the keys, so every query sees a key
    qpos = np.arange(sk - sq, sk, dtype=np.int32)
    kpos = np.arange(sk, dtype=np.int32)
    jnp, ja = jx.jnp, jx.attn

    def jfn(q_, k_, v_):
        return ja._attend_chunked(q_, k_, v_, jnp.asarray(qpos),
                                  jnp.asarray(kpos), causal, window,
                                  scale=scale, block=block)

    @jx.jax.jit
    def jref(q_, k_, v_, ct_):
        out, vjp = jx.jax.vjp(jfn, q_, k_, v_)
        mask = ja.make_mask(jnp.asarray(qpos), jnp.asarray(kpos), causal,
                            window)[None]
        return out, vjp(ct_), ja._attend(q_, k_, v_, mask, scale=scale)

    want, jgrads, dense = jref(q, k, v, ct)

    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    got = tattn._attend_chunked(*ins, _t(qpos), _t(kpos), causal, window,
                                scale=scale, block=block)
    grads = torch.autograd.grad(got, ins, _t(ct))
    close(got.detach(), want, CHUNK_TOL)
    close(got.detach(), dense, CHUNK_TOL)
    for gt, gj in zip(grads, jgrads):
        close(gt, gj, CHUNK_TOL)


def test_chunked_attention_row_without_keys_matches_jax_chunked(jx):
    """A row whose keys are all invalid (pos -1) averages every key, the
    block padding included, exactly as the reference's chunked path does
    (its dense path averages the valid length only)."""
    q, k, v, _ = _case(1, 2, 8, 20, 4, 2, 16, 16)
    kpos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    kpos[1] = -1
    qpos = np.arange(12, 20, dtype=np.int32)
    want = jx.attn._attend_chunked(
        *(jx.jnp.asarray(a) for a in (q, k, v, qpos, kpos)), True, None,
        block=16)
    got = tattn._attend_chunked(*(_t(a) for a in (q, k, v, qpos, kpos)),
                                True, None, block=16)
    close(got, want, CHUNK_TOL)
    # the padded row is the mean over 32 keys, 12 of them padding; heads
    # 0-1 read KV group 0, heads 2-3 group 1
    close(got[1, 0], np.repeat(v[1].sum(0) / 32, 2, axis=0), CHUNK_TOL)


# -- the MLA layer -----------------------------------------------------------


def _cfg(jx):
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx.cfg)
    assert cfg.attention.kind == "mla"
    return cfg


def _tparams(jx):
    return {k: _t(v) for k, v in jx.params.items()}


def test_mla_init_shapes_match_jax(jx):
    cfg = _cfg(jx)
    got = tattn.attention_init(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in jx.params.items()}
    assert all(v.dtype == torch.float32 for v in got.values())


def test_mla_apply_no_cache_matches_jax(jx):
    cfg = _cfg(jx)
    x = np.random.RandomState(4).randn(2, 9, cfg.d_model).astype(np.float32)
    want, _ = jx.jax.jit(lambda p, x_: jx.attn.mla_apply(p, jx.cfg, x_))(
        jx.params, x)
    got, cache = tattn.attention_apply(_tparams(jx), cfg, _t(x))
    assert cache is None
    close(got, want, 1e-5)


def test_mla_apply_paged_prefill_then_decode_matches_jax(jx):
    """A chunked-prefill call (S > 1; row 1 left-padded) then two decode
    steps, all through block tables, with ``paged_kernel=True`` on the
    decode steps (MLA ignores it, as the reference does: it gathers).
    Outputs within 1e-5 and the latent pool equal to JAX's."""
    cfg = _cfg(jx)
    jnp, ja = jx.jnp, jx.attn
    bs = 4
    tables = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    jcache = ja.init_paged_kv_cache(jx.cfg, 8, bs, dtype=jnp.float32)
    tcache = tattn.init_paged_kv_cache(cfg, 8, bs, dtype=torch.float32,
                                        device="cpu")
    assert set(tcache) == set(jcache) == {"ckv", "krope", "pos"}
    rng = np.random.RandomState(5)
    tp = _tparams(jx)
    jstep = jx.jax.jit(
        lambda p, x_, ps_, c, dec: ja.mla_apply(
            p, jx.cfg, x_, positions=ps_, cache=c, mode="decode",
            block_tables=jnp.asarray(tables), paged_kernel=dec),
        static_argnums=4)
    steps = [(rng.randn(2, 8, cfg.d_model),
              np.array([[-1, -1, 0, 1, 2, 3, 4, 5], np.arange(8)]))]
    steps += [(rng.randn(2, 1, cfg.d_model), np.array([[6 + i], [8 + i]]))
              for i in range(2)]
    for xs, ps in steps:
        xs, ps = xs.astype(np.float32), ps.astype(np.int32)
        decode = xs.shape[1] == 1
        want, jcache = jstep(jx.params, jnp.asarray(xs), jnp.asarray(ps),
                             jcache, decode)
        got, tcache = tattn.mla_apply(
            tp, cfg, _t(xs), positions=_t(ps), cache=tcache, mode="decode",
            block_tables=_t(tables), paged_kernel=decode)
        close(got, want, 1e-5)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for name in ("ckv", "krope"):
            close(tcache[name], jcache[name], 1e-5)


def test_mla_pool_fork_and_reset_match_jax(jx):
    """Copy-on-write fork and block reset are generic over the pool's
    names: on the latent pool they give JAX's pool."""
    cfg = _cfg(jx)
    rng = np.random.RandomState(6)
    jpool = jx.attn.init_paged_kv_cache(jx.cfg, 6, 4, dtype=jx.jnp.float32)
    pool = {k: rng.randn(*v.shape).astype(np.float32) for k, v in
            jpool.items() if k != "pos"}
    pool["pos"] = rng.randint(-1, 20, (6, 4)).astype(np.int32)
    jpool = {k: jx.jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: _t(v) for k, v in pool.items()}
    jpool = jx.attn.copy_kv_blocks(jpool, jx.jnp.asarray([1, 2]),
                                   jx.jnp.asarray([4, 5]))
    jpool = jx.attn.reset_block_pos(jpool, jx.jnp.asarray([2, 3]))
    tattn.copy_kv_blocks(tpool, [1, 2], [4, 5])
    tattn.reset_block_pos(tpool, [2, 3])
    assert tattn.init_paged_kv_cache(cfg, 6, 4, device="cpu")[
        "ckv"].dtype == torch.bfloat16
    for k in pool:
        np.testing.assert_array_equal(tpool[k].numpy(), np.asarray(jpool[k]))


def test_mla_apply_grads_match_jax(jx):
    cfg = _cfg(jx)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    ct = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    jnp = jx.jnp
    names = sorted(jx.params)

    def jfn(p, x_):
        return jnp.sum(jx.attn.mla_apply(p, jx.cfg, x_)[0] * ct)

    jgp, jgx = jx.jax.jit(jx.jax.grad(jfn, argnums=(0, 1)))(jx.params, x)
    tp = {k: v.requires_grad_() for k, v in _tparams(jx).items()}
    tx = _t(x).requires_grad_()
    out, _ = tattn.mla_apply(tp, cfg, tx)
    grads = torch.autograd.grad((out * _t(ct)).sum(),
                                [tp[k] for k in names] + [tx])
    for name, g, want in zip(names + ["x"], grads,
                             [jgp[k] for k in names] + [jgx]):
        want = np.asarray(want)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
            err_msg=name)


def test_mla_apply_chunked_path_matches_jax(jx, monkeypatch):
    """With the threshold lowered in both packages (16 keys x 1 query),
    the layer takes the chunked path: 20 tokens pad to one 1024-key
    block; output and input gradient within 1e-5 of JAX's chunked path."""
    monkeypatch.setattr(jx.attn, "_CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "_CHUNKED_THRESHOLD", 16)
    calls = []
    inner = tattn._attend_chunked
    monkeypatch.setattr(tattn, "_attend_chunked",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    cfg = _cfg(jx)
    x = np.random.RandomState(8).randn(2, 20, cfg.d_model).astype(np.float32)
    @jx.jax.jit
    def jref(x_):
        out, vjp = jx.jax.vjp(
            lambda x1: jx.attn.mla_apply(jx.params, jx.cfg, x1)[0], x_)
        return out, vjp(jx.jnp.ones_like(out))[0]

    want, jgx = jref(x)
    tx = _t(x).requires_grad_()
    got, _ = tattn.mla_apply(_tparams(jx), cfg, tx)
    (gx,) = torch.autograd.grad(got.sum(), [tx])
    assert calls == [1]
    close(got.detach(), want, 1e-5)
    close(gx, jgx, 1e-5)


def test_serving_params_keep_mla_up_projections_in_f32(jx):
    """MLA's ``w_uk`` and ``w_uv`` stay in their stored f32, as the
    reference reads them; the other attention weights are cast once to
    bf16, and a bf16 weight is passed on as it is, not copied."""
    cfg = reduced(get_config(ARCH))
    assert cfg.dtype == "bfloat16"
    from repro_torch.models import lm_init

    params = lm_init(torch.Generator().manual_seed(0), cfg)
    sp = serving_params(params, cfg)
    for layer, src in zip(sp["layers"], params["layers"]):
        attn = layer["attn"]
        for k in ("w_uk", "w_uv"):
            assert attn[k].dtype == torch.float32, k
            assert attn[k] is src["attn"][k]
        for k in ("wq", "w_dkv", "w_krope", "wo"):
            assert attn[k].dtype == torch.bfloat16, k
    again = serving_params(sp, cfg)
    assert again["layers"][0]["attn"]["wq"] is sp["layers"][0]["attn"]["wq"]
