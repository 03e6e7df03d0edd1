"""The port's routing-health kernel (K6), inspection and Soft-MoE telemetry
against the JAX package.

- The plain version of K6, which the wrapper runs on CPU tensors, against
  the JAX Pallas kernel in interpret mode at the same tiling (ragged
  tokens, several slot blocks, a ragged last slot block, rows of several
  of the kernel's token chunks with a ragged last one, two of its
  128-slot tiles), in f32 and with bf16 x, and against the chunked
  oracles of both packages: f32, atol and rtol 1e-5 (sums in other
  orders); its importance sums to m and its token contributions to S per
  row, within 1e-5 relative.
- ``core/inspection.py`` (streamed stats, the chunked twin, both
  ``routing_stats`` methods, ``summarize``) against the JAX module: f32,
  atol and rtol 1e-5.
- ``soft_moe_apply(telemetry=True)`` on the einsum and the kernel path
  against the JAX ``moe_apply``: rtol and atol 2e-5, as
  ``tests/test_telemetry.py`` holds the JAX paths to each other; y is the
  same bitwise with and without telemetry.
- Inside the port: a batched call equals the batch-1 calls bitwise; the
  telemetry carries no gradient.
- On a GPU (``cuda``-marked, skipped here): the CUDA kernel against its
  plain version, batched == batch-1 bitwise.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.core import inspection, moe_init, soft_moe_apply
from repro_torch.core.soft_moe import _dense_routing_health, soft_moe_weights
from repro_torch.kernels import ops
from repro_torch.kernels.soft_moe_kernels import (
    routing_fwd_ref,
    routing_health,
    routing_health_ref,
)
from repro_torch.kernels.tuning import KernelConfig

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.core import inspection as jinspection
    from repro.core import moe_apply as jmoe_apply
    from repro.core import moe_init as jmoe_init
    from repro.kernels import soft_moe_kernels as jk
    from repro.kernels.tuning import KernelConfig as JKernelConfig

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, k=jk, KernelConfig=JKernelConfig,
        MoEConfig=JMoEConfig, moe_init=jmoe_init, moe_apply=jmoe_apply,
        inspection=jinspection)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _inputs(seed, b, m, d, s, scale=1.3):
    """numpy x (b, m, d) and phi_n (d, S) = scale * l2norm(phi)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, m, d).astype(np.float32)
    phi = rng.randn(d, s).astype(np.float32)
    phi_n = (scale * phi / (np.sqrt((phi ** 2).sum(0, keepdims=True))
                            + 1e-6)).astype(np.float32)
    return x, phi_n


# (b, m, d, S, block_tokens, block_slots): ragged tokens and several slot
# blocks; a ragged last slot block; one row, one token block; rows of three
# of the kernel's token chunks (combine_chunk: 2 token blocks) with a ragged
# last one, over two of its 128-slot tiles (160 = 128 + 32, 136 = 128 + 8).
TILED = [(3, 20, 32, 20, 8, 8), (2, 45, 48, 40, 16, 16), (1, 9, 16, 24, 8, 8),
         (1, 150, 24, 160, 32, 32), (2, 70, 16, 136, 16, 8)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16x"])
@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_routing_health_matches_jax_kernel(jx, b, m, d, s, bt, bs,
                                                 bf16):
    x, phi_n = _inputs(b * 100 + m + 7, b, m, d, s)
    jcfg = jx.KernelConfig(block_tokens=bt, block_slots=bs, interpret=True)
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    jxa, tx = jx.jnp.asarray(x), _t(x)
    if bf16:  # both round x to bf16 the same way (to nearest even)
        jxa, tx = jxa.astype(jx.jnp.bfloat16), tx.bfloat16()
    jphi = jx.jnp.asarray(phi_n)
    _, jd, jc = jx.k.routing_fwd_pallas(jxa, jphi, jcfg)
    want = jx.k.routing_health_pallas(jxa, jphi, jd, jc, jcfg)
    oracle = jx.inspection.routing_health_from_stats(
        jxa.astype(jx.jnp.float32), jphi, jd, jc)
    stats = [tuple(_t(t) for t in st) for st in (jd, jc)]
    got = routing_health_ref(tx, _t(phi_n), *stats, cfg)
    port_oracle = inspection.routing_health_from_stats(tx.float(),
                                                       _t(phi_n), *stats)
    for g, w, o, po in zip(got, want, oracle, port_oracle):
        assert g.dtype == torch.float32
        _close(g, w)
        _close(g, o)
        _close(po, o)


def test_plain_routing_health_matches_dense_oracle():
    """K6 on K1's stats against the reductions of the materialized
    weights, with the default tile policy."""
    x, phi_n = _inputs(3, 2, 37, 24, 12)
    tx, tphi = _t(x), _t(phi_n)
    _, d_stats, c_stats = routing_fwd_ref(tx, tphi)
    got = routing_health_ref(tx, tphi, d_stats, c_stats)
    # soft_moe_weights(normalize=False) takes x as it is: hand it l2norm(x)
    xn = tx / (tx.norm(dim=-1, keepdim=True) + 1e-6)
    d_w, c_w = soft_moe_weights(xn, tphi.reshape(24, 12, 1), torch.ones(()),
                                normalize=False)
    for g, w in zip(got, _dense_routing_health(d_w, c_w)):
        _close(g, w)


@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_routing_health_row_independent_bitwise(b, m, d, s, bt, bs):
    x, phi_n = (_t(a) for a in _inputs(b + m, b + 1, m, d, s))
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    _, d_stats, c_stats = routing_fwd_ref(x, phi_n, cfg)
    full = routing_health_ref(x, phi_n, d_stats, c_stats, cfg)
    for r in range(x.shape[0]):
        one = routing_health_ref(x[r:r + 1], phi_n,
                                 tuple(t[r:r + 1] for t in d_stats),
                                 tuple(t[r:r + 1] for t in c_stats), cfg)
        for a, f in zip(one, full):
            assert torch.equal(a[0], f[r])


@pytest.mark.parametrize("b,m,d,s,bt,bs", TILED)
def test_plain_routing_health_sum_identities(b, m, d, s, bt, bs):
    """Each token's combine weights sum to 1 over the slots and each
    slot's dispatch weights to 1 over the tokens: per row the importance
    sums to m and the token contributions to S."""
    x, phi_n = (_t(a) for a in _inputs(b + m + s, b, m, d, s))
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    _, d_stats, c_stats = routing_fwd_ref(x, phi_n, cfg)
    _, imp, _, contrib = routing_health_ref(x, phi_n, d_stats, c_stats, cfg)
    _close(imp.sum(1), torch.full((b,), float(m)), atol=0, rtol=1e-5)
    _close(contrib.sum(1), torch.full((b,), float(s)), atol=0, rtol=1e-5)


def test_wrapper_runs_plain_version_on_cpu_and_carries_no_gradient():
    x, phi_n = (_t(a) for a in _inputs(5, 2, 20, 16, 8))
    _, d_stats, c_stats = routing_fwd_ref(x, phi_n)
    before = routing_health.launches
    want = routing_health_ref(x, phi_n, d_stats, c_stats)
    xg = x.clone().requires_grad_()
    got = ops.routing_health(xg, phi_n.clone().requires_grad_(), d_stats,
                             c_stats)
    assert routing_health.launches == before  # plain runs are not launches
    for g, w in zip(got, want):
        assert torch.equal(g, w) and not g.requires_grad
    with pytest.raises(ValueError, match="c_stats"):
        routing_health(x, phi_n, d_stats, (c_stats[0][:, :5], c_stats[1]))


def test_inspection_matches_jax(jx):
    x, phi_n = _inputs(11, 2, 40, 32, 12)
    jd, jc = jx.inspection.streaming_softmax_stats(
        jx.jnp.asarray(x), jx.jnp.asarray(phi_n), chunk_tokens=16)
    d_stats, c_stats = inspection.streaming_softmax_stats(
        _t(x), _t(phi_n), chunk_tokens=16)
    for g, w in zip(d_stats + c_stats, jd + jc):
        _close(g, w)
    want = jx.inspection.routing_health_from_stats(
        jx.jnp.asarray(x), jx.jnp.asarray(phi_n), jd, jc, chunk_tokens=16)
    got = inspection.routing_health_from_stats(_t(x), _t(phi_n), d_stats,
                                               c_stats, chunk_tokens=16)
    for g, w in zip(got, want):
        _close(g, w)

    jcfg = jx.MoEConfig(variant="soft", num_experts=4, slots_per_expert=3,
                        expert_d_ff=8)
    jparams = jx.moe_init(jx.jax.random.PRNGKey(0), 32, jcfg)
    params = {"phi": _t(jparams["phi"]), "scale": _t(jparams["scale"])}
    for method in ("dense", "chunked"):
        want = jx.inspection.routing_stats(jx.jnp.asarray(x), jparams,
                                           method=method, chunk_tokens=16)
        got = inspection.routing_stats(_t(x), params, method=method,
                                       chunk_tokens=16)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        jsum = jx.inspection.summarize(want)
        tsum = inspection.summarize(got)
        assert set(tsum) == set(jsum)
        for k in jsum:
            _close(tsum[k], jsum[k], atol=1e-4, rtol=1e-5)


def _moe_pair(jx, **kw):
    cfg = MoEConfig(variant="soft", num_experts=4, slots_per_expert=2,
                    expert_d_ff=16, **kw)
    jcfg = jx.MoEConfig(variant="soft", num_experts=4, slots_per_expert=2,
                        expert_d_ff=16, **kw)
    jparams = jx.moe_init(jx.jax.random.PRNGKey(1), 24, jcfg)
    params = jx.jax.tree_util.tree_map(_t, jparams)
    return cfg, jcfg, jparams, params


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _tree_close(got, want, atol, rtol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], atol, rtol)
    else:
        assert tuple(got.shape) == tuple(np.shape(want))
        _close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_soft_moe_telemetry_matches_jax(jx, use_kernel, shared):
    cfg, jcfg, jparams, params = _moe_pair(jx, num_shared_experts=shared)
    x = np.random.RandomState(2).randn(3, 19, 24).astype(np.float32)
    jy, jm = jx.moe_apply(jparams, jcfg, jx.jnp.asarray(x),
                          use_kernel=use_kernel, telemetry=True)
    y, m = soft_moe_apply(params, cfg, _t(x), use_kernel=use_kernel,
                          telemetry=True)
    _close(y, jy, atol=2e-5, rtol=2e-5)
    _tree_close(m["telemetry"], jm["telemetry"], 2e-5, 2e-5)
    y0, _ = soft_moe_apply(params, cfg, _t(x), use_kernel=use_kernel)
    assert torch.equal(y, y0)  # the flag never changes y


def test_soft_moe_telemetry_kernel_path_matches_einsum_path():
    gen = torch.Generator().manual_seed(0)
    cfg = MoEConfig(variant="soft", num_experts=6, expert_d_ff=8)
    params = moe_init(gen, 16, cfg)
    x = torch.randn(2, 33, 16, generator=gen)
    tk = soft_moe_apply(params, cfg, x, use_kernel=True,
                        telemetry=True)[1]["telemetry"]
    te = soft_moe_apply(params, cfg, x, telemetry=True)[1]["telemetry"]
    _tree_close(tk, _np_tree(te), 2e-5, 2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(3, 45, 264, 40, 32, 32),
                                  (2, 200, 64, 12, 16, 8),
                                  (1, 150, 24, 160, 32, 32),
                                  (2, 70, 16, 136, 16, 8)])
def test_cuda_routing_health_matches_plain_version(cuda, dtype, case):
    b, m, d, s, bt, bs = case
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    x, phi_n = (_t(a).cuda() for a in _inputs(sum(case), b, m, d, s))
    x = x.to(dtype)
    with torch.no_grad():
        d_stats, c_stats = routing_fwd_ref(x, phi_n, cfg)[1:]
    got = routing_health(x, phi_n, d_stats, c_stats, cfg)
    torch.cuda.synchronize()
    want = routing_health_ref(x, phi_n, d_stats, c_stats, cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
    for r in range(b):
        one = routing_health(x[r:r + 1], phi_n,
                             tuple(t[r:r + 1] for t in d_stats),
                             tuple(t[r:r + 1] for t in c_stats), cfg)
        assert all(torch.equal(a[0], g[r]) for a, g in zip(one, got))
