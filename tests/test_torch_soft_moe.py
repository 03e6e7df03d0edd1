"""The port's Soft-MoE layer and its kernels against the JAX package.

- The plain versions of K1 (routing), K2 (combine from saved stats) and
  K3 (online combine), which the wrappers run on CPU tensors, against the
  JAX Pallas kernels in interpret mode at the same tiling (ragged tokens,
  several slot blocks), and against the single-sequence oracle
  ``kernels/ref.py`` of both packages: f32, atol 1e-5 and rtol 1e-5 (the
  two sides sum in other orders).
- ``soft_moe_apply`` on the einsum and the kernel path, with and without
  shared experts, against the JAX ``moe_apply`` on both paths, with
  ``max_combine``: f32, atol 1e-5.
- Row independence inside the port: a batched call equals the batch-1
  calls bitwise.
- On a GPU (``cuda``-marked, skipped here): each CUDA kernel against its
  plain version, and the wrappers' refusals.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.core import moe_apply, moe_init, soft_moe_apply
from repro_torch.kernels import ops, ref
from repro_torch.kernels.soft_moe_kernels import (
    combine_2d,
    combine_apply,
    combine_apply_ref,
    combine_online,
    combine_online_ref,
    dispatch_2d,
    routing_fwd,
    routing_fwd_ref,
)
from repro_torch.kernels.tuning import (
    KernelConfig,
    config_from_moe,
    d_chunk,
    default_config,
)

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.core import moe_apply as jmoe_apply
    from repro.core import moe_init as jmoe_init
    from repro.kernels import ref as jref
    from repro.kernels import soft_moe_kernels as jk
    from repro.kernels.tuning import KernelConfig as JKernelConfig

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ref=jref, k=jk, KernelConfig=JKernelConfig,
        MoEConfig=JMoEConfig, moe_init=jmoe_init, moe_apply=jmoe_apply)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _inputs(seed, b, m, d, s, scale=1.3):
    """numpy x (b, m, d), phi_n (d, S) = scale * l2norm(phi), ys (b, S, d)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, m, d).astype(np.float32)
    phi = rng.randn(d, s).astype(np.float32)
    phi_n = (scale * phi / (np.sqrt((phi ** 2).sum(0, keepdims=True))
                            + 1e-6)).astype(np.float32)
    ys = rng.randn(b, s, d).astype(np.float32)
    return x, phi_n, ys


# (b, m, d, S, block_tokens, block_slots): ragged tokens and several slot
# blocks; a ragged last slot block; one row with a single token block.
TILED = [(3, 20, 32, 20, 8, 8), (2, 45, 48, 40, 16, 16), (1, 9, 16, 24, 8, 8)]


@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_routing_matches_jax_kernel(jx, b, m, d, s, bt, bs):
    x, phi_n, _ = _inputs(b * 100 + m, b, m, d, s)
    jcfg = jx.KernelConfig(block_tokens=bt, block_slots=bs, interpret=True)
    want = jx.k.routing_fwd_pallas(jx.jnp.asarray(x), jx.jnp.asarray(phi_n),
                                   jcfg)
    got = routing_fwd_ref(_t(x), _t(phi_n),
                          KernelConfig(block_tokens=bt, block_slots=bs))
    _close(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        _close(g, w)


@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_combines_match_jax_kernels(jx, b, m, d, s, bt, bs):
    x, phi_n, ys = _inputs(b * 100 + m + 1, b, m, d, s, scale=0.7)
    jcfg = jx.KernelConfig(block_tokens=bt, block_slots=bs, interpret=True)
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    jargs = [jx.jnp.asarray(a) for a in (x, phi_n, ys)]
    targs = [_t(a) for a in (x, phi_n, ys)]
    # K3: online combine and the stats it emits
    jy, jstats = jx.k.combine_online_pallas(*jargs, jcfg)
    y, stats = combine_online_ref(*targs, cfg)
    _close(y, jy)
    for g, w in zip(stats, jstats):
        _close(g, w)
    # K2: both sides fed the same (JAX) stats
    jy2 = jx.k.combine_apply_pallas(*jargs, jstats, jcfg)
    y2 = combine_apply_ref(*targs, tuple(_t(a) for a in jstats), cfg)
    _close(y2, jy2)
    # K2 on K1's stats equals K3, and K3's stats equal K1's
    _, _, c_stats = routing_fwd_ref(targs[0], targs[1], cfg)
    _close(combine_apply_ref(*targs, c_stats, cfg), y)
    for g, w in zip(stats, c_stats):
        _close(g, w)


@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_kernels_match_oracles(jx, b, m, d, s, bt, bs):
    x, phi_n, ys = _inputs(b * 7 + m, b, m, d, s)
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    slots = routing_fwd_ref(_t(x), _t(phi_n), cfg)[0]
    y = combine_online_ref(_t(x), _t(phi_n), _t(ys), cfg)[0]
    for i in range(b):
        want_s = jx.ref.dispatch_ref(jx.jnp.asarray(x[i]),
                                     jx.jnp.asarray(phi_n))
        want_y = jx.ref.combine_ref(jx.jnp.asarray(x[i]),
                                    jx.jnp.asarray(phi_n),
                                    jx.jnp.asarray(ys[i]))
        _close(slots[i], want_s)
        _close(y[i], want_y)
        # the port's own oracle agrees with the JAX one
        _close(ref.dispatch_ref(_t(x[i]), _t(phi_n)), want_s)
        _close(ref.combine_ref(_t(x[i]), _t(phi_n), _t(ys[i])), want_y)
        _close(ref.logits_ref(_t(x[i]), _t(phi_n)),
               jx.ref.logits_ref(jx.jnp.asarray(x[i]),
                                 jx.jnp.asarray(phi_n)))


def test_single_sequence_wrappers_match_jax(jx):
    x, phi_n, ys = _inputs(3, 1, 37, 24, 30)
    jargs = [jx.jnp.asarray(a[0]) if a.ndim == 3 else jx.jnp.asarray(a)
             for a in (x, phi_n, ys)]
    _close(dispatch_2d(_t(x[0]), _t(phi_n), bt=16, bs=8),
           jx.k.dispatch_pallas(jargs[0], jargs[1], bt=16, bs=8,
                                interpret=True))
    _close(combine_2d(_t(x[0]), _t(phi_n), _t(ys[0]), bt=16, bs=8),
           jx.k.combine_pallas(*jargs, bt=16, bs=8, interpret=True))


def test_normalized_phi_matches_jax(jx):
    rng = np.random.RandomState(4)
    phi = rng.randn(16, 4, 2).astype(np.float32)
    from repro.kernels import ops as jops

    _close(ops.normalized_phi(_t(phi), torch.tensor(1.7)),
           jops.normalized_phi(jx.jnp.asarray(phi), 1.7))


def _moe_pair(jx, n, p, d, d_ff, shared, seed=0):
    """The same Soft-MoE layer in both packages: JAX-initialised params
    carried over through numpy."""
    jcfg = jx.MoEConfig(variant="soft", num_experts=n, slots_per_expert=p,
                        expert_d_ff=d_ff, num_shared_experts=shared)
    tcfg = MoEConfig(variant="soft", num_experts=n, slots_per_expert=p,
                     expert_d_ff=d_ff, num_shared_experts=shared)
    jparams = jx.moe_init(jx.jax.random.PRNGKey(seed), d, jcfg,
                          style="classic")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _t(tree)

    return jcfg, tcfg, jparams, conv(jparams)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_soft_moe_apply_matches_jax(jx, shared, use_kernel):
    n, p, d, d_ff = 6, 2, 32, 48
    jcfg, tcfg, jparams, tparams = _moe_pair(jx, n, p, d, d_ff, shared)
    x = np.random.RandomState(5).randn(3, 21, d).astype(np.float32)
    jy, jm = jx.moe_apply(jparams, jcfg, jx.jnp.asarray(x), "gelu",
                          use_kernel=use_kernel)
    y, m = moe_apply(tparams, tcfg, _t(x), "gelu", use_kernel=use_kernel)
    _close(y, jy)
    _close(m["max_combine"], jm["max_combine"])
    assert float(m["moe_aux_loss"]) == 0.0


def test_soft_moe_kernel_path_matches_einsum_path():
    n, p, d = 8, 1, 40
    cfg = MoEConfig(variant="soft", num_experts=n, slots_per_expert=p,
                    expert_d_ff=24)
    params = moe_init(torch.Generator().manual_seed(0), d, cfg, "classic")
    x = torch.randn(2, 30, d, generator=torch.Generator().manual_seed(1))
    y0, m0 = soft_moe_apply(params, cfg, x, "gelu", use_kernel=False)
    y1, m1 = soft_moe_apply(params, cfg, x, "gelu", use_kernel=True)
    torch.testing.assert_close(y1, y0, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(m1["max_combine"], m0["max_combine"],
                               atol=ATOL, rtol=RTOL)


def test_soft_moe_apply_matches_single_sequence_oracle():
    d, n = 24, 10
    cfg = MoEConfig(variant="soft", num_experts=n, expert_d_ff=16)
    params = moe_init(torch.Generator().manual_seed(2), d, cfg, "classic")
    x = torch.randn(2, 13, d, generator=torch.Generator().manual_seed(3))
    y, _ = soft_moe_apply(params, cfg, x, "gelu", use_kernel=True)
    from repro_torch.layers.mlp import experts_apply

    def expert_fn(slots):  # (S, d), one slot per expert
        return experts_apply(params["experts"], slots[:, None], "gelu")[:, 0]

    for i in range(2):
        want = ref.soft_moe_ref(x[i], params["phi"].reshape(d, n),
                                params["scale"], expert_fn)
        torch.testing.assert_close(y[i], want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("p", [1, 2])
def test_kernel_path_hands_the_kernels_contiguous_operands(monkeypatch, p):
    """The CUDA wrappers refuse strided operands; on the CPU the plain
    versions would take them, so check the layer's calls here."""
    seen = []

    def spy(fn):
        def call(*args, **kw):
            seen.extend(t.is_contiguous() for t in args
                        if isinstance(t, torch.Tensor))
            return fn(*args, **kw)
        return call

    for name in ("routing_fwd", "combine_apply", "combine_online"):
        monkeypatch.setattr(ops, name, spy(getattr(ops, name)))
    cfg = MoEConfig(variant="soft", num_experts=4, slots_per_expert=p,
                    expert_d_ff=8)
    params = moe_init(torch.Generator().manual_seed(0), 16, cfg, "classic")
    soft_moe_apply(params, cfg, torch.randn(3, 10, 16), "gelu",
                   use_kernel=True)
    assert len(seen) >= 5 and all(seen)


@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_kernels_row_independent_bitwise(b, m, d, s, bt, bs):
    x, phi_n, ys = (_t(a) for a in _inputs(11, b + 1, m, d, s))
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    r = routing_fwd_ref(x, phi_n, cfg)
    y3, st3 = combine_online_ref(x, phi_n, ys, cfg)
    y2 = combine_apply_ref(x, phi_n, ys, r[2], cfg)
    for i in range(b + 1):
        xi, yi = x[i:i + 1], ys[i:i + 1]
        ri = routing_fwd_ref(xi, phi_n, cfg)
        assert torch.equal(ri[0][0], r[0][i])
        for g, w in zip(ri[1] + ri[2], r[1] + r[2]):
            assert torch.equal(g[0], w[i])
        y3i, st3i = combine_online_ref(xi, phi_n, yi, cfg)
        assert torch.equal(y3i[0], y3[i])
        assert all(torch.equal(g[0], w[i]) for g, w in zip(st3i, st3))
        stats_i = tuple(t[i:i + 1] for t in r[2])
        assert torch.equal(combine_apply_ref(xi, phi_n, yi, stats_i, cfg)[0],
                           y2[i])


def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    x, phi_n, ys = (_t(a) for a in _inputs(12, 2, 17, 16, 12))
    before = (routing_fwd.launches, combine_apply.launches,
              combine_online.launches)
    cfg = KernelConfig(block_tokens=8, block_slots=8)
    slots, d_stats, c_stats = routing_fwd(x, phi_n, cfg)
    want = routing_fwd_ref(x, phi_n, cfg)
    assert torch.equal(slots, want[0])
    assert torch.equal(combine_apply(x, phi_n, ys, c_stats, cfg),
                       combine_apply_ref(x, phi_n, ys, c_stats, cfg))
    assert torch.equal(combine_online(x, phi_n, ys, cfg)[0],
                       combine_online_ref(x, phi_n, ys, cfg)[0])
    # the ops: with stats -> K2, without -> K3; with_d_stats adds (d_mx, d_den)
    s2, ds, cs = ops.soft_moe_routing(x, phi_n, cfg, with_d_stats=True)
    assert torch.equal(ds[1], d_stats[1]) and torch.equal(cs[0], c_stats[0])
    torch.testing.assert_close(ops.soft_moe_combine(x, phi_n, ys, cs, cfg),
                               ops.soft_moe_combine(x, phi_n, ys, None, cfg),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(ops.soft_moe_dispatch(x, phi_n, cfg), slots)
    assert (routing_fwd.launches, combine_apply.launches,
            combine_online.launches) == before


def test_tile_policy():
    # Hopper default: 32 x 32 blocks, clamped to the problem; the
    # narrowest built d-chunk that covers d, else the widest
    cfg = default_config(196, 768, 128)
    assert (cfg.block_tokens, cfg.block_slots, d_chunk(768)) == (32, 32, 768)
    cfg = default_config(20, 64, 12)
    assert (cfg.block_tokens, cfg.block_slots, d_chunk(64)) == (24, 16, 128)
    assert d_chunk(384) == 384 and d_chunk(264) == 384
    assert d_chunk(1024) == d_chunk(1280) == 768
    moe = MoEConfig(variant="soft", num_experts=128)
    assert config_from_moe(moe, 196, 768) == default_config(196, 768, 128)
    pinned = dataclasses.replace(moe, kernel_block_tokens=16,
                                 kernel_block_slots=8)
    cfg = config_from_moe(pinned, 196, 768)
    assert (cfg.block_tokens, cfg.block_slots) == (16, 8)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")


# (b, m, d, S, cfg): ragged tokens and slots; a chunk wider than d
# (264 of 384 columns) and L/16's d = 1024 over two 768-column chunks
CUDA_CASES = [(3, 70, 264, 40, None),
              (2, 45, 1024, 40, KernelConfig(block_tokens=16, block_slots=8))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("case", range(len(CUDA_CASES)))
def test_cuda_kernels_match_plain_versions(cuda, dtype, rtol, case):
    """f32 within 1e-5; bf16 outputs within one bf16 step (both sides
    agree in f32, then round); stats f32 within 1e-5 relative."""
    b, m, d, s, cfg = CUDA_CASES[case]
    x, phi_n, ys = (_t(a).cuda() for a in _inputs(case, b, m, d, s))
    x, ys = x.to(dtype), ys.to(dtype)
    launches = routing_fwd.launches
    got = routing_fwd(x, phi_n, cfg)
    torch.cuda.synchronize()
    assert routing_fwd.launches == launches + 1
    want = routing_fwd_ref(x, phi_n, cfg)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=1e-5,
                               rtol=rtol)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    y2 = combine_apply(x, phi_n, ys, want[2], cfg)
    y3, st3 = combine_online(x, phi_n, ys, cfg)
    torch.testing.assert_close(
        y2.float(), combine_apply_ref(x, phi_n, ys, want[2], cfg).float(),
        atol=1e-5, rtol=rtol)
    wy3, wst3 = combine_online_ref(x, phi_n, ys, cfg)
    torch.testing.assert_close(y3.float(), wy3.float(), atol=1e-5, rtol=rtol)
    for g, w in zip(st3, wst3):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # batched == batch-1, bitwise
    for i in range(b):
        gi = routing_fwd(x[i:i + 1], phi_n, cfg)
        assert torch.equal(gi[0][0], got[0][i])
        assert torch.equal(combine_online(x[i:i + 1], phi_n, ys[i:i + 1],
                                          cfg)[0][0], y3[i])


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, phi_n, ys = (_t(a).cuda() for a in _inputs(0, 2, 20, 32, 16))
    before = routing_fwd.launches
    with pytest.raises(TypeError):
        routing_fwd(x.half(), phi_n)
    with pytest.raises(TypeError):
        routing_fwd(x, phi_n.double())
    with pytest.raises(ValueError, match="contiguous"):
        routing_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), phi_n)
    with pytest.raises(ValueError, match="multiple of 8"):
        routing_fwd(x[..., :28].contiguous(), phi_n[:28].contiguous())
    with pytest.raises(ValueError, match="block_tokens"):
        routing_fwd(x, phi_n, KernelConfig(block_tokens=64))
    with pytest.raises(NotImplementedError, match="kernels/ops.py"):
        routing_fwd(x.requires_grad_(), phi_n)
    assert routing_fwd.launches == before
    with torch.no_grad():
        routing_fwd(x, phi_n)
    assert routing_fwd.launches == before + 1
