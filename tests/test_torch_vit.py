"""The port's Soft-MoE ViT against the JAX package: reduced
``soft_moe_vit("s", 32, 8)`` in f32 with JAX-initialised weights carried
over by ``params_from_jax(..., device="cpu")`` and a non-zero head drawn
here (the head starts at zero, so untrained logits would prove nothing).
``vit_apply`` logits, ``vit_features`` and ``vit_loss`` on the einsum and
the kernel path (the JAX kernels in interpret mode, the port's plain
versions) agree within atol 1e-4 and rtol 1e-4 (four layers of f32 sums
in other orders). On a GPU (``cuda``-marked, skipped here) the port's
kernel path is held against its einsum path.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced, soft_moe_vit
from repro_torch.convert import params_from_jax
from repro_torch.kernels.soft_moe_kernels import routing_fwd
from repro_torch.models import vit_apply, vit_features, vit_init, vit_loss

TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced as jreduced
    from repro.configs import soft_moe_vit as jsoft_moe_vit
    from repro.models.vit import vit_apply as jvit_apply
    from repro.models.vit import vit_features as jvit_features
    from repro.models.vit import vit_init as jvit_init
    from repro.models.vit import vit_loss as jvit_loss

    cfg = dataclasses.replace(jreduced(jsoft_moe_vit("s", 32, 8)),
                              dtype="float32")
    params = jvit_init(jax.random.PRNGKey(0), cfg, num_classes=10)
    rng = np.random.RandomState(0)
    head = {"w": rng.randn(cfg.d_model, 10).astype(np.float32) * 0.5,
            "b": rng.randn(10).astype(np.float32) * 0.1}
    params = dict(params, head={k: jnp.asarray(v) for k, v in head.items()})
    patches = rng.randn(3, cfg.frontend.num_embeds,
                        cfg.frontend.embed_dim).astype(np.float32)
    labels = np.array([1, 7, 3], np.int32)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=cfg, params=params, patches=patches,
        labels=labels, apply=jvit_apply, features=jvit_features,
        loss=jvit_loss)


def _port(jx):
    cfg = dataclasses.replace(reduced(soft_moe_vit("s", 32, 8)),
                              dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx.cfg)
    tree = jx.jax.tree_util.tree_map(np.asarray, jx.params)
    return cfg, params_from_jax(tree, cfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vit_matches_jax(jx, use_kernel):
    cfg, params = _port(jx)
    assert len(params["layers"]) == cfg.num_layers
    assert [("moe" in p) for p in params["layers"]] == [
        i in cfg.moe_layer_indices() for i in range(cfg.num_layers)]
    patches = jx.jnp.asarray(jx.patches)
    tp = torch.from_numpy(jx.patches)
    jlogits, jaux = jx.apply(jx.params, jx.cfg, patches,
                             use_kernel=use_kernel)
    logits, aux = vit_apply(params, cfg, tp, use_kernel=use_kernel)
    assert float(np.abs(np.asarray(jlogits)).max()) > 0.1
    _close(logits, jlogits)
    assert float(aux) == float(jaux) == 0.0
    _close(vit_features(params, cfg, tp, use_kernel=use_kernel),
           jx.features(jx.params, jx.cfg, patches, use_kernel=use_kernel))
    batch = {"patches": patches, "labels": jx.jnp.asarray(jx.labels)}
    jl, jm = jx.loss(jx.params, jx.cfg, batch, use_kernel=use_kernel)
    tl, tm = vit_loss(params, cfg, {"patches": tp,
                                    "labels": torch.from_numpy(jx.labels)},
                      use_kernel=use_kernel)
    _close(tl, jl)
    _close(tm["loss"], jm["loss"])
    assert float(tm["accuracy"]) == float(jm["accuracy"])


def test_vit_init_shapes_and_zero_head():
    cfg = reduced(soft_moe_vit("s", 32, 8))
    params = vit_init(torch.Generator().manual_seed(0), cfg, num_classes=5)
    d = cfg.d_model
    assert params["patch_proj"]["w"].shape == (cfg.frontend.embed_dim, d)
    assert params["pos_emb"].shape == (cfg.frontend.num_embeds, d)
    assert not params["head"]["w"].any() and params["head"]["w"].shape == (
        d, 5)
    moe = [i for i, p in enumerate(params["layers"]) if "moe" in p]
    assert moe == list(cfg.moe_layer_indices())
    n = cfg.moe.num_experts
    assert params["layers"][moe[0]]["moe"]["phi"].shape == (d, n, 1)
    x = torch.randn(2, cfg.frontend.num_embeds, cfg.frontend.embed_dim)
    logits, _ = vit_apply(params, cfg, x, use_kernel=True)
    assert logits.shape == (2, 5) and not logits.any()


@pytest.mark.cuda
def test_cuda_vit_kernel_path_matches_einsum_path():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    cfg = dataclasses.replace(soft_moe_vit("s", 32, 8), dtype="float32",
                              num_layers=4)
    params = vit_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    x = torch.randn(4, cfg.frontend.num_embeds, cfg.frontend.embed_dim,
                    device="cuda")
    before = routing_fwd.launches
    with torch.inference_mode():
        f0 = vit_features(params, cfg, x, use_kernel=False)
        f1 = vit_features(params, cfg, x, use_kernel=True)
    assert routing_fwd.launches == before + len(cfg.moe_layer_indices())
    torch.testing.assert_close(f1, f0, atol=TOL, rtol=TOL)
