"""The port's Mamba-2 (SSD) layer against the JAX package's, in f32:

- ``ssd_chunked`` on lengths that are and are not a multiple of the
  chunk, with and without an initial state, with one and two B/C groups;
- ``ssd_decode_step``, ``_causal_conv`` with a ring, ``_segsum``;
- ``ssm_apply`` at reduced mamba2 width: no cache; a cached chunked
  prefill with a left pad and an inactive row (its state and ring
  bitwise unchanged) and its continuation; decode steps; the cache
  updated in place as JAX returns it;
- ``reset_ssm_rows`` and ``init_ssm_cache``;
- sequential decode against the chunked form (1e-4), and ``ssm_apply``'s
  gradients against ``jax.grad`` (1e-4).

Outputs within 1e-5 (absolute and relative). The JAX reference is
imported by the ``jx`` fixture, so that the file also collects on a GPU
machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.layers import ssm as tssm

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.layers import ssm as jssm

    cfg = dataclasses.replace(jreduced(jget_config("mamba2-370m")),
                              dtype="float32")
    return types.SimpleNamespace(jax=jax, jnp=jnp, ssm=jssm, cfg=cfg)


def _cfg():
    return dataclasses.replace(reduced(get_config("mamba2-370m")),
                               dtype="float32")


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _scan_inputs(seed, s, g=1, b=2, h=4, dh=8, n=16):
    """x, dt (after softplus), A, B, C, a state: numpy f32."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(
        x=rng.randn(b, s, h, dh).astype(f),
        dt=np.log1p(np.exp(rng.randn(b, s, h) - 1.0)).astype(f),
        A=-np.exp(rng.uniform(0.0, 1.5, h)).astype(f),
        B=rng.randn(b, s, g, n).astype(f),
        C=rng.randn(b, s, g, n).astype(f),
        state=rng.randn(b, h, dh, n).astype(f),
    )


def _layer_params(cfg, seed=0):
    """``ssm_init`` params with the constant leaves (conv_b, D,
    norm_scale, dt_bias) perturbed, so every leaf reaches the output."""
    p = tssm.ssm_init(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.RandomState(seed + 100)
    for k in ("conv_b", "D", "norm_scale", "dt_bias"):
        p[k] = p[k] + torch.from_numpy(
            0.3 * rng.randn(*p[k].shape).astype(np.float32))
    return p


def _jp(jx, p):
    return {k: jx.jnp.asarray(v.detach().numpy()) for k, v in p.items()}


@pytest.mark.parametrize("s,g,init", [
    (32, 1, False), (37, 1, False), (32, 1, True), (37, 2, True), (5, 1, True),
], ids=["divisible", "ragged", "divisible-state", "ragged-state-2groups",
        "shorter-than-chunk"])
def test_ssd_chunked_matches_jax(jx, s, g, init):
    d = _scan_inputs(s + g, s, g=g)
    chunk = 16 if s >= 16 else s
    state = d["state"] if init else None
    jy, jst = jx.jax.jit(
        lambda x, dt, A, B, C, st: jx.ssm.ssd_chunked(x, dt, A, B, C, chunk,
                                                      st))(
        d["x"], d["dt"], d["A"], d["B"], d["C"], state)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y, st = tssm.ssd_chunked(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk,
                             t["state"] if init else None)
    assert y.shape == (2, s, 4, 8) and y.dtype == torch.float32
    assert st.shape == (2, 4, 8, 16) and st.dtype == torch.float32
    close(y, jy)
    close(st, jst)


def test_ssd_decode_step_and_segsum_match_jax(jx):
    d = _scan_inputs(7, 1, g=2)
    jy, jst = jx.jax.jit(jx.ssm.ssd_decode_step)(d["x"], d["dt"], d["A"],
                                                 d["B"], d["C"], d["state"])
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y, st = tssm.ssd_decode_step(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                 t["state"])
    close(y, jy)
    close(st, jst)
    y0, st0 = tssm.ssd_decode_step(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                   None)
    jy0, jst0 = jx.jax.jit(lambda *a: jx.ssm.ssd_decode_step(*a, None))(
        d["x"], d["dt"], d["A"], d["B"], d["C"])
    close(y0, jy0)
    close(st0, jst0)
    seg = np.random.RandomState(1).randn(2, 3, 6).astype(np.float32)
    got, want = tssm._segsum(torch.from_numpy(seg)), jx.ssm._segsum(seg)
    assert torch.equal(torch.isinf(got), torch.from_numpy(
        np.isinf(np.asarray(want))))
    close(torch.where(torch.isinf(got), 0.0, got),
          np.where(np.isinf(want), 0.0, want))


@pytest.mark.parametrize("ring", [False, True], ids=["no-ring", "ring"])
def test_causal_conv_matches_jax(jx, ring):
    rng = np.random.RandomState(3)
    xbc = rng.randn(2, 6, 10).astype(np.float32)
    w = rng.randn(4, 10).astype(np.float32)
    bias = rng.randn(10).astype(np.float32)
    state = rng.randn(2, 3, 10).astype(np.float32) if ring else None
    jout, jst = jx.ssm._causal_conv(xbc, w, bias, state)
    out, st = tssm._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(bias),
        None if state is None else torch.from_numpy(state))
    close(out, jout)
    assert torch.equal(st, torch.from_numpy(np.array(jst)))


def test_ssm_apply_without_cache_matches_jax(jx):
    cfg = _cfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx.cfg)
    p = _layer_params(cfg)
    x = np.random.RandomState(4).randn(2, 37, cfg.d_model).astype(np.float32)
    jout, jc = jx.jax.jit(lambda p, x: jx.ssm.ssm_apply(p, jx.cfg, x))(
        _jp(jx, p), x)
    out, c = tssm.ssm_apply(p, cfg, torch.from_numpy(x))
    assert jc is None and c is None
    close(out, jout)


def _cache_np(c):
    return {k: v.numpy().copy() for k, v in c.items()}


def test_ssm_apply_with_cache_matches_jax(jx):
    """Three rows: a chunked prefill of 20 tokens (row 0 left-padded by
    5, row 2 inactive), its continuation over 12 more, then 4 decode steps
    with row 2 inactive throughout and row 1 inactive at step 2. The
    cache is updated in place and equals JAX's; the inactive row's state
    and ring stay bitwise as they were."""
    cfg = _cfg()
    p = _layer_params(cfg, seed=1)
    jp = _jp(jx, p)
    rng = np.random.RandomState(5)
    cache = tssm.init_ssm_cache(cfg, 3, torch.float32, device="cpu")
    # a nonzero carried state and ring in the inactive row
    cache["conv"][2] = torch.from_numpy(
        rng.randn(*cache["conv"].shape[1:]).astype(np.float32))
    cache["state"][2] = torch.from_numpy(
        rng.randn(*cache["state"].shape[1:]).astype(np.float32))
    frozen = {k: v[2].clone() for k, v in cache.items()}
    jcache = {k: jx.jnp.asarray(v) for k, v in _cache_np(cache).items()}
    japply = jx.jax.jit(lambda p, x, c, pos, mode: jx.ssm.ssm_apply(
        p, jx.cfg, x, cache=c, mode=mode, positions=pos),
        static_argnums=(4,))

    def pos_rows(start, n, pad0=0, dead=(2,)):
        pos = np.tile(np.arange(start, start + n, dtype=np.int32), (3, 1))
        pos[0, :pad0] = -1
        for r in dead:
            pos[r] = -1
        return pos

    steps = [(20, pos_rows(0, 20, pad0=5)), (12, pos_rows(20, 12))]
    steps += [(1, pos_rows(32 + i, 1, dead=(2, 1) if i == 2 else (2,)))
              for i in range(4)]
    for n, pos in steps:
        x = rng.randn(3, n, cfg.d_model).astype(np.float32)
        mode = "decode"
        jout, jcache = japply(jp, x, jcache, pos, mode)
        before = {k: v.clone() for k, v in cache.items()}
        out, c = tssm.ssm_apply(p, cfg, torch.from_numpy(x), cache=cache,
                                mode=mode, positions=torch.from_numpy(pos))
        assert c is cache
        close(out, jout)
        close(cache["conv"], jcache["conv"])
        close(cache["state"], jcache["state"])
        for k in cache:
            assert torch.equal(cache[k][2], frozen[k]), k
            dead = (pos < 0).all(axis=1)
            for r in np.nonzero(dead)[0]:
                assert torch.equal(cache[k][r], before[k][r]), (k, r)


def test_reset_rows_and_cache_init(jx):
    cfg = _cfg()
    c = tssm.init_ssm_cache(cfg, 3, device="cpu")
    jc = jx.ssm.init_ssm_cache(jx.cfg, 3)
    for k in ("conv", "state"):
        assert tuple(c[k].shape) == tuple(jc[k].shape), k
    assert c["conv"].dtype == torch.bfloat16
    assert c["state"].dtype == torch.float32
    assert str(jc["conv"].dtype) == "bfloat16"
    assert str(jc["state"].dtype) == "float32"
    with pytest.raises(TypeError, match="device"):
        tssm.init_ssm_cache(cfg, 3)
    rng = np.random.RandomState(6)
    c = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
         for k, v in c.items()}
    jr = jx.ssm.reset_ssm_rows({k: jx.jnp.asarray(v.numpy())
                                for k, v in c.items()}, 1)
    assert tssm.reset_ssm_rows(c, 1) is c
    for k in c:
        assert np.array_equal(c[k].numpy(), np.asarray(jr[k])), k


def test_sequential_decode_matches_chunked():
    """Token-by-token decode through the cache equals one chunked pass
    (within 1e-4), outputs and final state."""
    cfg = _cfg()
    p = _layer_params(cfg, seed=2)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 24, cfg.d_model).astype(np.float32))
    whole = tssm.init_ssm_cache(cfg, 2, torch.float32, device="cpu")
    want, _ = tssm.ssm_apply(p, cfg, x, cache=whole, mode="decode",
                             positions=torch.arange(24))
    step = tssm.init_ssm_cache(cfg, 2, torch.float32, device="cpu")
    outs = [tssm.ssm_apply(p, cfg, x[:, i:i + 1], cache=step, mode="decode",
                           positions=torch.tensor([i]))[0]
            for i in range(24)]
    close(torch.cat(outs, dim=1), want.numpy(), GRAD_TOL)
    for k in ("conv", "state"):
        close(step[k], whole[k].numpy(), GRAD_TOL)
    nocache, _ = tssm.ssm_apply(p, cfg, x)
    close(nocache, want.numpy(), TOL)


def test_ssm_apply_grads_match_jax(jx):
    """Gradients of sum(out * w) with respect to every parameter and the
    input, against ``jax.grad``, on a ragged length over two chunks."""
    cfg = _cfg()
    p = _layer_params(cfg, seed=3)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 21, cfg.d_model).astype(np.float32)
    w = rng.randn(2, 21, cfg.d_model).astype(np.float32)

    def jloss(p, x):
        return (jx.ssm.ssm_apply(p, jx.cfg, x)[0] * w).sum()

    jgp, jgx = jx.jax.jit(jx.jax.grad(jloss, argnums=(0, 1)))(_jp(jx, p), x)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tssm.ssm_apply(leaves, cfg, tx)[0] * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [*leaves.values(), tx])
    for (k, _), g in zip(leaves.items(), grads):
        want = np.asarray(jgp[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max())
    close(grads[-1], jgx, GRAD_TOL)
