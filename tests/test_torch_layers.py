"""The port's layers against the JAX package on the same numpy inputs, in
f32 at atol 1e-5: norms, rotary embedding, embed/unembed with softcap,
the MLPs, and GQA attention with no cache, through a paged prefill chunk
(gather path) and a paged decode step on the kernel route."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.layers import attention as jattn
from repro.layers import common as jcommon
from repro.layers import embedding as jemb
from repro.layers import mlp as jmlp
from repro.layers import rotary as jrope
from repro_torch.configs import get_config, reduced
from repro_torch.layers import attention as tattn
from repro_torch.layers import common as tcommon
from repro_torch.layers import embedding as temb
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import rotary as trope

ATOL = 1e-5


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def configs(name, **attn_kw):
    """The same reduced config from both packages, in f32."""
    out = []
    for get, red in ((jax_get_config, jax_reduced), (get_config, reduced)):
        cfg = dataclasses.replace(red(get(name)), dtype="float32")
        if attn_kw:
            cfg = dataclasses.replace(
                cfg, attention=dataclasses.replace(cfg.attention, **attn_kw))
        out.append(cfg)
    return out


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply(norm):
    jcfg, tcfg = (dataclasses.replace(c, norm=norm)
                  for c in configs("qwen2-0.5b"))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3 + 1
    p = {"scale": rng.randn(64).astype(np.float32),
         "bias": rng.randn(64).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    close(tcommon.norm_apply(to_torch(p), tcfg, torch.from_numpy(x)),
          jcommon.norm_apply(p, jcfg, jnp.asarray(x)))


def test_apply_rope_per_row_positions():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 3, 16).astype(np.float32)
    pos = np.array([np.arange(6), [-1, -1, 0, 1, 2, 3]], np.int32)
    close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_embed_unembed(softcap):
    rng = np.random.RandomState(2)
    table = {"table": rng.randn(50, 32).astype(np.float32) * 3}
    toks = rng.randint(0, 50, (2, 7))
    x = jemb.embed(table, jnp.asarray(toks), jnp.float32)
    close(temb.embed(to_torch(table), torch.from_numpy(toks),
                     torch.float32), x)
    close(temb.unembed(to_torch(table), torch.from_numpy(np.asarray(x)),
                       softcap),
          jemb.unembed(table, x, softcap), atol=1e-4)


@pytest.mark.parametrize("style,act", [("gated", "silu"),
                                       ("classic", "gelu")])
def test_mlp_apply(style, act):
    p = jmlp.mlp_init(jax.random.PRNGKey(0), 32, 48, style)
    x = np.random.RandomState(3).randn(2, 5, 32).astype(np.float32)
    close(tmlp.mlp_apply(to_torch(p), torch.from_numpy(x), act),
          jmlp.mlp_apply(p, jnp.asarray(x), act))


def _gqa_setup(kv_heads):
    jcfg, tcfg = configs("qwen2-0.5b", num_kv_heads=kv_heads)
    params = jattn.gqa_init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.RandomState(5)
    # non-zero biases so the QKV-bias path is exercised
    params = {k: (v + 0.1 * rng.randn(*v.shape).astype(np.float32)
                  if k.startswith("b") else v) for k, v in params.items()}
    return jcfg, tcfg, params, to_torch(params), rng


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_gqa_apply_no_cache(kv_heads):
    jcfg, tcfg, jp, tp, rng = _gqa_setup(kv_heads)
    x = rng.randn(2, 9, jcfg.d_model).astype(np.float32)
    out, _ = tattn.gqa_apply(tp, tcfg, torch.from_numpy(x))
    ref, _ = jattn.gqa_apply(jp, jcfg, jnp.asarray(x))
    close(out, ref)


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_gqa_apply_paged_prefill_then_kernel_decode(kv_heads):
    """A chunked-prefill call (S > 1, gather path; row 1 left-padded)
    then a single-token decode step on the kernel route, both through
    block tables. Outputs and the pools' valid entries match JAX."""
    jcfg, tcfg, jp, tp, rng = _gqa_setup(kv_heads)
    bs = 4
    tables = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    jcache = jattn.init_paged_kv_cache(jcfg, 8, bs, dtype=jnp.float32)
    tcache = tattn.init_paged_kv_cache(tcfg, 8, bs, dtype=torch.float32,
                                        device="cpu")
    x = rng.randn(2, 8, jcfg.d_model).astype(np.float32)
    poss = np.array([[-1, -1, 0, 1, 2, 3, 4, 5], np.arange(8)], np.int32)
    for s, xs, ps in ((8, x, poss),
                      (1, rng.randn(2, 1, jcfg.d_model).astype(np.float32),
                       np.array([[6], [8]], np.int32))):
        ref, jcache = jattn.gqa_apply(
            jp, jcfg, jnp.asarray(xs), positions=jnp.asarray(ps),
            cache=jcache, mode="decode", block_tables=jnp.asarray(tables),
            paged_kernel=s == 1)
        out, tcache = tattn.gqa_apply(
            tp, tcfg, torch.from_numpy(xs), positions=torch.from_numpy(ps),
            cache=tcache, mode="decode", block_tables=torch.from_numpy(tables),
            paged_kernel=s == 1)
        close(out, ref)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for name in ("k", "v"):
            close(tcache[name].numpy(), np.asarray(jcache[name]))
