"""The port's LM against the JAX package: the configs copy, the param
converter, and ``lm_apply`` in paged serving mode (two prefill chunks,
then single-token decode steps on the kernel route) on JAX-initialised
weights; logits allclose at atol 1e-4 in f32."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_NAMES, PAPER_MODELS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm_apply as jax_lm_apply
from repro.models import lm_init as jax_lm_init
from repro.serve.block_manager import init_paged_cache as jax_paged_cache
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import lm_apply, lm_init
from repro_torch.serve.block_manager import init_paged_cache

ATOL = 1e-4


@pytest.mark.parametrize("name", ASSIGNED_NAMES + ("qwen2-0.5b+soft",)
                         + tuple(m.name for m in PAPER_MODELS))
def test_configs_copy_matches_jax(name):
    for red in (False, True):
        j, t = jax_get_config(name), get_config(name)
        if red:
            j, t = jax_reduced(j), reduced(t)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def _configs(name, **attn_kw):
    out = []
    for get, red in ((jax_get_config, jax_reduced), (get_config, reduced)):
        cfg = dataclasses.replace(red(get(name)), dtype="float32")
        if attn_kw:
            cfg = dataclasses.replace(
                cfg, attention=dataclasses.replace(cfg.attention, **attn_kw))
        out.append(cfg)
    return out


# reduced qwen2 has one kv group; the copy with 2 groups tests G > 1;
# reduced gemma3 (window 16, softcap 30, gelu) with every 2nd layer global
CASES = {
    "qwen2": ("qwen2-0.5b", {}),
    "qwen2-g2": ("qwen2-0.5b", {"num_kv_heads": 2}),
    "gemma3": ("gemma3-27b", {"global_every": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lm_apply_paged_prefill_and_decode_matches_jax(case):
    name, attn_kw = CASES[case]
    jcfg, tcfg = _configs(name, **attn_kw)
    jparams = jax_lm_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, "cpu")
    assert len(tparams["layers"]) == tcfg.num_layers
    bs, nblk = 4, 16
    tables = np.array([[5, 2, 9, 1, 3, 4, 0, 0], [6, 7, 8, 10, 11, 0, 0, 0]],
                      np.int32)
    jcache = jax_paged_cache(jcfg, nblk, bs, 1, dtype=jnp.float32)
    tcache = init_paged_cache(tcfg, nblk, bs, dtype=torch.float32,
                              device="cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab_size, (2, 24))
    # two 10-token chunks (row 1 left-padded), then four decode steps:
    # positions reach 20+ > the reduced gemma3 window of 16
    steps = [(toks[:, :10], np.array([[-1, -1] + list(range(8)),
                                      list(range(10))])),
             (toks[:, 10:20], np.array([range(8, 18), range(10, 20)]))]
    steps += [(toks[:, 20 + i:21 + i], np.array([[18 + i], [20 + i]]))
              for i in range(4)]

    @functools.partial(jax.jit, static_argnames=("kernel",))
    def jax_step(params, t, p, cache, kernel):
        logits, cache, _ = jax_lm_apply(
            params, jcfg, t, positions=p, cache=cache, mode="decode",
            block_tables=jnp.asarray(tables), paged_kernel=kernel)
        return logits, cache

    for t, p in steps:
        p = p.astype(np.int32)
        kernel = t.shape[1] == 1
        jlogits, jcache = jax_step(jparams, jnp.asarray(t), jnp.asarray(p),
                                   jcache, kernel=kernel)
        tlogits, tcache, _ = lm_apply(
            tparams, tcfg, torch.from_numpy(t), positions=torch.from_numpy(p),
            cache=tcache, mode="decode", block_tables=torch.from_numpy(tables),
            paged_kernel=kernel)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=ATOL)


def test_params_from_jax_keeps_dtypes_and_values():
    jcfg, tcfg = _configs("qwen2-0.5b")
    jparams = jax_lm_init(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["embed"]["table"] = tree["embed"]["table"].astype(jnp.bfloat16)
    out = params_from_jax(tree, tcfg, device="cpu")
    assert out["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["embed"]["table"].float().numpy(),
        tree["embed"]["table"].astype(np.float32))
    wq = tree["segments"][0]["attn"]["wq"]  # (L, d, H, Dk)
    for i, layer in enumerate(out["layers"]):
        assert layer["attn"]["wq"].dtype == torch.float32
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), wq[i])


def test_port_lm_init_shapes_match_jax():
    """The port's own initialiser builds the JAX param shapes, split per
    layer, with lecun-scaled weights."""
    jcfg, tcfg = _configs("qwen2-0.5b", num_kv_heads=2)
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jax_lm_init(jax.random.PRNGKey(0), jcfg))
    ref = params_from_jax(jtree, tcfg, device="cpu")
    mine = lm_init(torch.Generator().manual_seed(0), tcfg)

    def shapes(t):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), t)

    assert shapes(mine) == shapes(ref)
    wq = mine["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 0.88) < 0.1
    assert float(wq.abs().max()) <= 2.0 / tcfg.d_model ** 0.5 + 1e-6
