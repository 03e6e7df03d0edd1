"""The port's Soft-MoE backward (K4, K5 and the autograd Functions of
``kernels/ops.py``) against the JAX package.

- The plain versions of K4 (dispatch backward) and K5 (combine backward),
  which the wrappers run on CPU tensors, against the JAX Pallas kernels
  ``dispatch_bwd_pallas`` / ``combine_bwd_pallas`` in interpret mode, at
  the ragged shapes of the JAX gradient tests (``tests/test_kernels.py``
  ``GRAD_SHAPES``: ragged tokens, ragged slots, batch > 1) and pinned
  tiling, fed the same forward residuals: f32, atol 1e-5 and rtol 1e-5
  (the two sides sum in other orders).
- Autograd through ``ops.soft_moe_routing`` + ``ops.soft_moe_combine``
  with the non-trivial loss of ``tests/test_kernels.py::_kernel_loss``,
  against ``jax.grad`` of the JAX kernel path (interpret mode) and
  against autograd of the port's single-sequence oracle ``kernels/ref.py``:
  f32, rtol 1e-4 and atol 1e-6, as the JAX package's own test.
- ``soft_moe_apply`` gradients (every param and the input) on the einsum
  and the kernel path, with and without shared experts, against
  ``jax.grad`` of the JAX ``moe_apply``: f32, rtol 1e-4 and atol 1e-6.
- Inside the port: dx and dYs of a batched call equal batch-1 calls
  bitwise, and dPhi_n equals the row-order sum of the batch-1 dPhi_n's.
- On a GPU (``cuda``-marked, skipped here): K4 and K5 against their plain
  versions, and the autograd Functions against the einsum path's
  autograd.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import MoEConfig
from repro_torch.core import moe_apply, moe_init, soft_moe_apply
from repro_torch.kernels import ops, ref
from repro_torch.layers.common import activation
from repro_torch.kernels.soft_moe_kernels import (
    combine_apply,
    combine_bwd,
    combine_bwd_ref,
    dispatch_bwd,
    dispatch_bwd_ref,
    routing_fwd,
    routing_fwd_ref,
)
from repro_torch.kernels.tuning import KernelConfig

ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.core import moe_apply as jmoe_apply
    from repro.core import moe_init as jmoe_init
    from repro.kernels import ops as jops
    from repro.kernels import soft_moe_kernels as jk
    from repro.kernels.tuning import KernelConfig as JKernelConfig

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, k=jk, ops=jops, KernelConfig=JKernelConfig,
        MoEConfig=JMoEConfig, moe_init=jmoe_init, moe_apply=jmoe_apply)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _inputs(seed, b, m, d, s, scale=1.1):
    """numpy x (b, m, d), phi_n (d, S) = scale * l2norm(phi), ys (b, S, d),
    and the gradients g_slots (b, S, d), g (b, m, d)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, m, d).astype(np.float32)
    phi = rng.randn(d, s).astype(np.float32)
    phi_n = (scale * phi / (np.sqrt((phi ** 2).sum(0, keepdims=True))
                            + 1e-6)).astype(np.float32)
    ys, g_slots = (rng.randn(b, s, d).astype(np.float32) for _ in range(2))
    g = rng.randn(b, m, d).astype(np.float32)
    return x, phi_n, ys, g_slots, g


# (b, m, d, S, block_tokens, block_slots): the JAX gradient tests' shapes
# at their 64-wide blocks (aligned; ragged tokens; ragged slots over
# several slot blocks), ragged last blocks on both axes at 16 x 8, and
# m over five chunks of BWD_TILES 8-token blocks with a ragged last one
# (70 = 4 x 16 + 6)
GRAD_SHAPES = [(1, 64, 32, 16, 64, 64), (2, 100, 48, 24, 64, 64),
               (3, 72, 32, 150, 64, 64), (2, 45, 24, 20, 16, 8),
               (2, 70, 24, 20, 8, 8)]


@pytest.mark.parametrize("b,m,d,s,bt,bs", GRAD_SHAPES)
def test_plain_backward_matches_jax_kernels(jx, b, m, d, s, bt, bs):
    x, phi_n, ys, g_slots, g = _inputs(b * 31 + m, b, m, d, s)
    jcfg = jx.KernelConfig(block_tokens=bt, block_slots=bs, interpret=True)
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    jarr = {k: jx.jnp.asarray(v) for k, v in
            dict(x=x, phi_n=phi_n, ys=ys, g_slots=g_slots, g=g).items()}
    # the forward residuals, from the JAX kernels, fed to both sides
    slots, d_stats, c_stats = jx.k.routing_fwd_pallas(jarr["x"],
                                                      jarr["phi_n"], jcfg)
    y = jx.k.combine_apply_pallas(jarr["x"], jarr["phi_n"], jarr["ys"],
                                  c_stats, jcfg)
    want4 = jx.k.dispatch_bwd_pallas(jarr["x"], jarr["phi_n"],
                                     jarr["g_slots"], d_stats, slots, jcfg)
    want5 = jx.k.combine_bwd_pallas(jarr["x"], jarr["phi_n"], jarr["ys"],
                                    jarr["g"], c_stats, y, jcfg)
    got4 = dispatch_bwd_ref(_t(x), _t(phi_n), _t(g_slots),
                            tuple(_t(a) for a in d_stats), _t(slots), cfg)
    got5 = combine_bwd_ref(_t(x), _t(phi_n), _t(ys), _t(g),
                           tuple(_t(a) for a in c_stats), _t(y), cfg)
    for got, want in zip(got4 + got5, want4 + want5):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)


def _kernel_loss(x, phi_n, ys, cfg):
    slots, c_stats = ops.soft_moe_routing(x, phi_n, config=cfg)
    y = ops.soft_moe_combine(x, phi_n, ys + 0.5 * slots, c_stats=c_stats,
                             config=cfg)
    return (y ** 2).mean() + (slots ** 3).mean()


def _oracle_loss(x, phi_n, ys):
    slots = torch.stack([ref.dispatch_ref(xi, phi_n) for xi in x])
    y = torch.stack([ref.combine_ref(xi, phi_n, yi)
                     for xi, yi in zip(x, ys + 0.5 * slots)])
    return (y ** 2).mean() + (slots ** 3).mean()


def test_ops_autograd_matches_jax_grad_and_oracle(jx):
    b, m, d, s = 3, 72, 32, 150  # ragged slots over three slot blocks
    x, phi_n, ys, _, _ = _inputs(b * 7 + m, b, m, d, s)
    jcfg = jx.KernelConfig(block_tokens=64, block_slots=64, interpret=True)

    def jloss(x, phi_n, ys):
        slots, c_stats = jx.ops.soft_moe_routing(x, phi_n, config=jcfg)
        y = jx.ops.soft_moe_combine(x, phi_n, ys + 0.5 * slots,
                                    c_stats=c_stats, config=jcfg)
        return (y ** 2).mean() + (slots ** 3).mean()

    want = jx.jax.grad(jloss, argnums=(0, 1, 2))(
        *(jx.jnp.asarray(a) for a in (x, phi_n, ys)))
    args = [_t(a).requires_grad_() for a in (x, phi_n, ys)]
    got = torch.autograd.grad(
        _kernel_loss(*args, KernelConfig(block_tokens=64, block_slots=64)),
        args)
    oracle = torch.autograd.grad(_oracle_loss(*args), args)
    for g_, w, o in zip(got, want, oracle):
        _close(g_, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        _close(g_, o, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_ops_online_combine_backward_equals_stats_path():
    """K3's Function (stats from its own online pass) and K2's (K1's
    stats) give the same gradients: both backwards are K5."""
    x, phi_n, ys, _, g = _inputs(5, 2, 37, 24, 20)
    cfg = KernelConfig(block_tokens=16, block_slots=8)
    grads = []
    for online in (False, True):
        args = [_t(a).requires_grad_() for a in (x, phi_n, ys)]
        c_stats = None
        if not online:
            c_stats = ops.soft_moe_routing(args[0], args[1], cfg)[1]
        y = ops.soft_moe_combine(*args, c_stats=c_stats, config=cfg)
        grads.append(torch.autograd.grad(y, args, _t(g)))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, atol=ATOL, rtol=RTOL)


def test_stats_outputs_carry_no_gradient():
    x, phi_n, _, _, _ = _inputs(6, 2, 9, 16, 8)
    xt = _t(x).requires_grad_()
    slots, d_stats, c_stats = ops.soft_moe_routing(xt, _t(phi_n),
                                                   with_d_stats=True)
    assert slots.requires_grad
    assert not any(t.requires_grad for t in d_stats + c_stats)


def _moe_pair(jx, n, p, d, d_ff, shared, seed=0):
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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_soft_moe_apply_grads_match_jax(jx, shared, use_kernel):
    n, p, d, d_ff = 6, 2, 16, 24
    jcfg, tcfg, jparams, tparams = _moe_pair(jx, n, p, d, d_ff, shared)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 21, d).astype(np.float32)
    w = rng.randn(2, 21, d).astype(np.float32)

    def jloss(params, x):
        y, _ = jx.moe_apply(params, jcfg, x, "gelu", use_kernel=use_kernel)
        return (y ** 2).mean() + (y * jx.jnp.asarray(w)).sum()

    jg, jgx = jx.jax.grad(jloss, argnums=(0, 1))(jparams, jx.jnp.asarray(x))
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_()
    xt = _t(x).requires_grad_()
    y, _ = moe_apply(tparams, tcfg, xt, "gelu", use_kernel=use_kernel)
    loss = (y ** 2).mean() + (y * _t(w)).sum()
    got = torch.autograd.grad(loss, [*leaves.values(), xt])
    want = _flat(jg)
    assert list(want) == list(leaves)
    for g_, w_ in zip(got, [*want.values(), jgx]):
        assert float(np.abs(np.asarray(w_)).max()) > 0
        _close(g_, w_, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("b,m,d,s,bt,bs", [(3, 20, 32, 20, 8, 8),
                                           (2, 45, 48, 40, 16, 16),
                                           (2, 40, 16, 12, 8, 8)])
def test_plain_backward_row_independent_bitwise(b, m, d, s, bt, bs):
    """dx and dYs of a batched call equal batch-1 calls bitwise, and dPhi_n
    is the row-order sum of the batch-1 dPhi_n's, each a row's chunk
    partials summed in chunk order (the last shape: three chunks of
    BWD_TILES 8-token blocks, 40 = 16 + 16 + 8)."""
    x, phi_n, ys, g_slots, g = (_t(a) for a in _inputs(11, b, m, d, s))
    cfg = KernelConfig(block_tokens=bt, block_slots=bs)
    slots, d_stats, c_stats = routing_fwd_ref(x, phi_n, cfg)
    y = ops.soft_moe_combine(x, phi_n, ys, c_stats, cfg)
    dx4, dphi4 = dispatch_bwd_ref(x, phi_n, g_slots, d_stats, slots, cfg)
    dx5, dphi5, dys5 = combine_bwd_ref(x, phi_n, ys, g, c_stats, y, cfg)
    acc4, acc5 = torch.zeros_like(dphi4), torch.zeros_like(dphi5)
    for i in range(b):
        sl = slice(i, i + 1)
        rx4, rp4 = dispatch_bwd_ref(x[sl], phi_n, g_slots[sl],
                                    tuple(t[sl] for t in d_stats), slots[sl],
                                    cfg)
        rx5, rp5, ry5 = combine_bwd_ref(x[sl], phi_n, ys[sl], g[sl],
                                        tuple(t[sl] for t in c_stats), y[sl],
                                        cfg)
        assert torch.equal(rx4[0], dx4[i]) and torch.equal(rx5[0], dx5[i])
        assert torch.equal(ry5[0], dys5[i])
        acc4, acc5 = acc4 + rp4, acc5 + rp5
    assert torch.equal(acc4, dphi4) and torch.equal(acc5, dphi5)


def _moe_layer_f64(params, x, n, p):
    """The Soft-MoE layer (classic experts, the repo's tanh gelu) in f64
    throughout: the reference of the bf16 gradient check below."""
    def l2n(t, dim):
        return t / (torch.sqrt((t * t).sum(dim, keepdim=True)) + 1e-6)

    b, m, d = x.shape
    logits = l2n(x, -1) @ (params["scale"] * l2n(params["phi"].reshape(d, -1),
                                                 0))
    d_w, c_w = torch.softmax(logits, 1), torch.softmax(logits, -1)
    xs = (d_w.transpose(1, 2) @ x).reshape(b, n, p, d).permute(1, 0, 2, 3)
    e = params["experts"]
    h = activation("gelu")(xs.reshape(n, b * p, d) @ e["w_up"])
    ys = (h @ e["w_down"]).reshape(n, b, p, d).permute(1, 0, 2, 3)
    return c_w @ ys.reshape(b, n * p, d)


def test_bf16_scale_gradient_kernel_and_einsum_paths_against_f64():
    """The MoE ``scale`` gradient in bf16 compute (bf16 layer input, f32
    params, as the ViT runs it) on the kernel path (K1/K2 forward, K4/K5
    backward: their plain versions here) and on the einsum path, each
    against the f64 gradient of the same layer on the same inputs, over 32
    seeds at a reduced layer (b 4, m 49, d 64, 32 one-slot experts).

    The gradient is one number summed over d S terms of both signs, so a
    bf16 rounding anywhere moves it by much more than its own share. Both
    paths round x, the slots and the expert outputs to bf16 at the same
    points; they differ in the routing arithmetic (the kernels normalize x
    and form the logits in f32, the einsum path normalizes in bf16).
    Measured (pytest -s prints it): median relative errors 5.7e-3 (kernel)
    and 5.3e-3 (einsum), the kernel path nearer in 21 of 32 seeds. So
    neither path is nearer: the kernel-vs-einsum spread of the ViT check
    is bf16 rounding both paths share. Bounds: each median within 1e-2
    (about twice the measured ones), and each path nearer in at least 8
    of 32 seeds."""
    n, d = 32, 64
    cfg = MoEConfig(variant="soft", num_experts=n, slots_per_expert=1,
                    expert_d_ff=32)
    errs = {"kernel": [], "einsum": []}
    for seed in range(32):
        params = moe_init(torch.Generator().manual_seed(seed), d, cfg,
                          "classic")
        rng = np.random.RandomState(seed)
        x = torch.from_numpy(rng.randn(4, 49, d).astype(np.float32)).to(
            torch.bfloat16)
        w = torch.from_numpy(rng.randn(4, 49, d))
        p64 = {k: v.double() for k, v in _flat(params).items()}
        scale = p64["/scale"].requires_grad_()
        tree = {"phi": p64["/phi"], "scale": scale,
                "experts": {k.split("/")[-1]: v for k, v in p64.items()
                            if k.startswith("/experts/")}}
        y = _moe_layer_f64(tree, x.double(), n, 1)
        ref = torch.autograd.grad((y * w).sum(), scale)[0].item()
        for path in errs:
            leaves = {k: v.clone() for k, v in _flat(params).items()}
            scale = leaves["/scale"].requires_grad_()
            tree = {"phi": leaves["/phi"], "scale": scale,
                    "experts": {k.split("/")[-1]: v for k, v in leaves.items()
                                if k.startswith("/experts/")}}
            y, _ = soft_moe_apply(tree, cfg, x, "gelu",
                                  use_kernel=path == "kernel")
            got = torch.autograd.grad((y.double() * w).sum(), scale)[0].item()
            errs[path].append(abs(got - ref) / abs(ref))
    med = {k: float(np.median(v)) for k, v in errs.items()}
    kernel_nearer = sum(a < b for a, b in zip(errs["kernel"],
                                              errs["einsum"]))
    print(f"bf16 scale gradient vs f64, 32 seeds: median rel err kernel "
          f"{med['kernel']:.3e}, einsum {med['einsum']:.3e}; kernel path "
          f"nearer in {kernel_nearer} of 32")
    assert med["kernel"] <= 1e-2 and med["einsum"] <= 1e-2
    assert 8 <= kernel_nearer <= 24


def test_backward_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    x, phi_n, ys, g_slots, g = (_t(a) for a in _inputs(12, 2, 17, 16, 12))
    cfg = KernelConfig(block_tokens=8, block_slots=8)
    before = (dispatch_bwd.launches, combine_bwd.launches)
    slots, d_stats, c_stats = routing_fwd(x, phi_n, cfg)
    y = combine_apply(x, phi_n, ys, c_stats, cfg)
    for got, want in zip(
            dispatch_bwd(x, phi_n, g_slots, d_stats, slots, cfg),
            dispatch_bwd_ref(x, phi_n, g_slots, d_stats, slots, cfg)):
        assert torch.equal(got, want)
    for got, want in zip(combine_bwd(x, phi_n, ys, g, c_stats, y, cfg),
                         combine_bwd_ref(x, phi_n, ys, g, c_stats, y, cfg)):
        assert torch.equal(got, want)
    # an empty batch: dPhi_n is an empty sum
    e4 = dispatch_bwd(x[:0], phi_n, g_slots[:0], tuple(t[:0] for t in
                                                      d_stats), slots[:0])
    assert e4[0].shape == (0, 17, 16) and not e4[1].any()
    with pytest.raises(ValueError, match="slots"):
        dispatch_bwd(x, phi_n, g_slots, d_stats, slots[:, :5])
    with pytest.raises(ValueError, match="c_stats"):
        combine_bwd(x, phi_n, ys, g, (c_stats[0][:, :3], c_stats[1]), y)
    assert (dispatch_bwd.launches, combine_bwd.launches) == before


def test_kernel_path_backward_hands_the_kernels_contiguous_operands(
        monkeypatch):
    """The gradients reach the backward wrappers through reshapes and
    permutes; the CUDA wrappers refuse strided operands, the CPU plain
    versions would take them, so check the Functions' calls here."""
    seen = []

    def spy(fn):
        def call(*args, **kw):
            for a in args:
                for t in (a if isinstance(a, tuple) else (a,)):
                    if isinstance(t, torch.Tensor):
                        seen.append(t.is_contiguous())
            return fn(*args, **kw)
        return call

    for name in ("dispatch_bwd", "combine_bwd"):
        monkeypatch.setattr(ops, name, spy(getattr(ops, name)))
    cfg = MoEConfig(variant="soft", num_experts=4, slots_per_expert=2,
                    expert_d_ff=8)
    params = moe_init(torch.Generator().manual_seed(0), 16, cfg, "classic")
    x = torch.randn(3, 10, 16, requires_grad=True)
    y, _ = soft_moe_apply(params, cfg, x, "gelu", use_kernel=True)
    y.square().sum().backward()
    assert len(seen) >= 12 and all(seen)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")


# (b, m, d, S, cfg): ragged tokens, slots and columns (a last d-tile of 8
# of 32 columns); L/16's d = 1024 at 16 x 8 blocks (32-token chunks); m
# over several 64-token chunks with a ragged last one (300 = 4 x 64 + 44)
# and S over two slot tiles of the kernels (150 = 128 + 22)
CUDA_CASES = [(3, 70, 264, 40, None),
              (2, 45, 1024, 40, KernelConfig(block_tokens=16, block_slots=8)),
              (2, 300, 264, 150, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CUDA_CASES)))
def test_cuda_backward_kernels_match_plain_versions(cuda, dtype, case):
    """max |diff| / max |ref| within 1e-5 in f32; bf16 outputs elementwise
    within one bf16 step (2^-7 |ref|) plus 1e-5 max |ref|; dPhi_n is f32.
    Batched == batch-1 bitwise; dPhi_n is the row-order sum, and bitwise
    the same over two runs."""
    b, m, d, s, cfg = CUDA_CASES[case]
    x, phi_n, ys, g_slots, g = (_t(a).cuda() for a in _inputs(case, b, m, d,
                                                               s))
    x, ys, g_slots, g = (t.to(dtype) for t in (x, ys, g_slots, g))
    with torch.no_grad():
        slots, d_stats, c_stats = routing_fwd(x, phi_n, cfg)
        y = combine_apply(x, phi_n, ys, c_stats, cfg)
    launches = (dispatch_bwd.launches, combine_bwd.launches)
    got = (dispatch_bwd(x, phi_n, g_slots, d_stats, slots, cfg)
           + combine_bwd(x, phi_n, ys, g, c_stats, y, cfg))
    torch.cuda.synchronize()
    assert (dispatch_bwd.launches, combine_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = (dispatch_bwd_ref(x, phi_n, g_slots, d_stats, slots, cfg)
            + combine_bwd_ref(x, phi_n, ys, g, c_stats, y, cfg))
    for gt, wt in zip(got, want):
        diff = (gt.float() - wt.float()).abs()
        top = wt.float().abs().max()
        if gt.dtype == torch.float32:
            assert diff.max() <= 1e-5 * top
        else:
            assert bool((diff <= 2.0**-7 * wt.float().abs() + 1e-5 * top)
                        .all())
    acc4 = acc5 = 0
    for i in range(b):
        sl = slice(i, i + 1)
        rx4, rp4 = dispatch_bwd(x[sl], phi_n, g_slots[sl],
                                tuple(t[sl] for t in d_stats), slots[sl], cfg)
        rx5, rp5, ry5 = combine_bwd(x[sl], phi_n, ys[sl], g[sl],
                                    tuple(t[sl] for t in c_stats), y[sl], cfg)
        assert torch.equal(rx4[0], got[0][i]) and torch.equal(rx5[0],
                                                              got[2][i])
        assert torch.equal(ry5[0], got[4][i])
        acc4, acc5 = acc4 + rp4, acc5 + rp5
    assert torch.equal(acc4, got[1]) and torch.equal(acc5, got[3])
    again = dispatch_bwd(x, phi_n, g_slots, d_stats, slots, cfg)
    assert torch.equal(again[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [0, 1])
def test_cuda_autograd_functions_match_einsum_path(cuda, shared):
    """soft_moe_apply's gradients on the kernel path (K1/K2 forward, K4/K5
    backward) against the einsum path's autograd, f32: within 1e-4 of the
    largest value of each gradient."""
    cfg = MoEConfig(variant="soft", num_experts=16, slots_per_expert=2,
                    expert_d_ff=64, num_shared_experts=shared)
    params = moe_init(torch.Generator(device="cuda").manual_seed(0), 96,
                      cfg, "classic")
    x = torch.randn(4, 50, 96, device="cuda")
    grads = []
    for use_kernel in (False, True):
        leaves = {k: v.detach().requires_grad_() for k, v in
                  _flat(params).items()}
        p = {"phi": leaves["/phi"], "scale": leaves["/scale"],
             "experts": {k.split("/")[-1]: v for k, v in leaves.items()
                         if k.startswith("/experts/")}}
        if shared:
            p["shared"] = {k.split("/")[-1]: v for k, v in leaves.items()
                           if k.startswith("/shared/")}
        xt = x.clone().requires_grad_()
        before = (dispatch_bwd.launches, combine_bwd.launches)
        y, _ = soft_moe_apply(p, cfg, xt, "gelu", use_kernel=use_kernel)
        grads.append(torch.autograd.grad(y.square().mean(),
                                         [*leaves.values(), xt]))
        if use_kernel:
            assert (dispatch_bwd.launches, combine_bwd.launches) == (
                before[0] + 1, before[1] + 1)
    for k, e in zip(*grads):
        assert ((k - e).abs().max() / e.abs().max()).item() <= 1e-4
