"""The port's sharding rules and mesh context against the JAX package's.

- ``param_specs`` equal the JAX ``param_specs`` leaf by leaf and path by
  path, for the 10 ``ASSIGNED`` archs, granite-moe-1b-a400m+soft and
  ``soft_moe_vit("s", 32, 8)``: reduced (``fsdp_min_size=0``, so the FSDP
  axis shows) and at full width (the default options: the 2**16 FSDP
  threshold cuts differently at real widths), the port's tree built on
  the meta device by ``abstract_params`` against JAX's ``eval_shape``.
  The reference stacks a segment's layers under ``segments/s`` (its
  specs lead with the never-sharded layer axis); the port keeps one dict
  per layer under ``layers/i``, whose spec is the segment's without it.
- The six rule cases of ``tests/test_sharding.py`` through the port.
- ``logical_to_physical`` and ``spec`` equal the reference's on (data,
  model), (pod, data, model) and under ``dp_over_model``.
- ``tree_shardings`` (placements read back as partition specs) equal the
  reference's ``NamedSharding`` specs for full-width hymba-1.5b (25
  heads: the divisibility fallback) and granite-moe-1b-a400m+soft on a
  (2, 4) mesh, plain and under ``dp_over_model``, and on (2, 2, 2) with
  a pod axis; the reference runs in a subprocess with 8 fake devices, as
  ``tests/test_sharding.py`` runs it.

The port's rule functions read only a mesh's dimension names and sizes,
so in this process they take a stand-in mesh; ``tests/
test_torch_collectives.py`` drives them on real ``DeviceMesh`` ranks.
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_config, reduced
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.vit import soft_moe_vit
from repro_torch.distributed import (
    ShardingOptions,
    abstract_params,
    batch_sharding,
    constrain,
    logical_to_physical,
    param_specs,
    spec,
    tree_shardings,
    use_mesh,
)
from repro_torch.models import build_model, segment_plan
from repro_torch.models.encdec import _enc_cfg

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = [c.name for c in ASSIGNED] + ["granite-moe-1b-a400m+soft", "vit"]


def _cfg(name):
    return soft_moe_vit("s", 32, 8) if name == "vit" else get_config(name)


def _mesh(shape, names):
    """A stand-in for a ``DeviceMesh``: its dimension names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=tuple(names),
                                 shape=tuple(shape), ndim=len(shape))


def _port_flat(tree):
    """{path: leaf} over dicts and lists (a spec or placements tuple is a
    leaf)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = t

    walk(tree, "")
    return out


def _jax_flat(jax, params, specs):
    """{path: spec} of the JAX ``param_specs`` (tuples are pytree nodes,
    so the specs are read at the params' leaves)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = treedef.flatten_up_to(specs)
    out = {}
    for (path, _), sp in zip(flat, leaves):
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = sp
    return out


def _to_port_paths(flat, cfg):
    """The JAX paths and specs in the port's layout: segment s's stacked
    spec becomes each of its layers' spec without the layer axis."""
    plans = {"segments": ("layers", segment_plan(cfg))}
    if cfg.encoder_layers:
        plans["enc_segments"] = ("enc_layers", segment_plan(_enc_cfg(cfg)))
    out = {}
    for path, sp in flat.items():
        head, *rest = path.split("/")
        if head not in plans:
            out[path] = sp
            continue
        name, plan = plans[head]
        start, count, _ = plan[int(rest[0])]
        assert sp[0] is None  # the scanned layer axis is never sharded
        for j in range(count):
            out["/".join([name, str(start + j)] + rest[1:])] = tuple(sp[1:])
    return out


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.configs.vit import soft_moe_vit as jsoft_moe_vit
    from repro.distributed import ShardingOptions as JOptions
    from repro.distributed import abstract_params as jabstract
    from repro.distributed import logical_to_physical as jl2p
    from repro.distributed import param_specs as jparam_specs
    from repro.distributed import spec as jspec
    from repro.distributed import use_mesh as juse_mesh
    from repro.models import build_model as jbuild_model

    def cfg(name):
        return jsoft_moe_vit("s", 32, 8) if name == "vit" else \
            jget_config(name)

    return types.SimpleNamespace(
        jax=jax, cfg=cfg, reduced=jreduced, Options=JOptions,
        abstract=jabstract, param_specs=jparam_specs, l2p=jl2p, spec=jspec,
        use_mesh=juse_mesh, build_model=jbuild_model)


def _compare(jx, name, full):
    jcfg = jx.cfg(name) if full else jx.reduced(jx.cfg(name))
    cfg = _cfg(name) if full else reduced(_cfg(name))
    kw = {} if full else {"fsdp_min_size": 0}
    jparams = jx.abstract(jx.build_model(jcfg)[0], jx.jax.random.PRNGKey(0))
    want = _to_port_paths(
        _jax_flat(jx.jax, jparams,
                  jx.param_specs(jparams, jx.Options(**kw))), cfg)
    params = abstract_params(build_model(cfg)[0])
    leaves = _port_flat(params)
    assert {t.device.type for t in leaves.values()} == {"meta"}
    got = _port_flat(param_specs(params, ShardingOptions(**kw)))
    assert got == want
    return got


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_jax_reduced(jx, name):
    got = _compare(jx, name, full=False)
    assert any("data" in sp for sp in got.values())  # FSDP shows


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_jax_full_width(jx, name):
    _compare(jx, name, full=True)


def _specs_for(name, opts=None):
    cfg = reduced(get_config(name))
    params = abstract_params(build_model(cfg)[0])
    return param_specs(params, opts or ShardingOptions(fsdp_min_size=0))


def _moe_layer(specs, cfg):
    return specs["layers"][cfg.moe_layer_indices()[0]]


def test_attention_and_mlp_rules():
    specs = _specs_for("llama3-8b")
    lay0 = specs["layers"][0]
    # heads over model; FSDP over data (no stacked layer axis in the port)
    assert lay0["attn"]["wq"] == ("data", "model", None)
    assert lay0["attn"]["wo"] == ("model", None, "data")
    assert lay0["mlp"]["w_gate"] == ("data", "model")
    assert lay0["mlp"]["w_down"] == ("model", "data")
    assert specs["embed"]["table"] == ("model", "data")
    assert lay0["norm1"]["scale"] == (None,)


def test_expert_parallel_rules():
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    moe = _moe_layer(_specs_for("granite-moe-1b-a400m"), cfg)["moe"]
    assert moe["experts"]["w_gate"] == ("model", "data", None)
    assert moe["router"] == ("data", None)


def test_soft_moe_phi_rule():
    cfg = reduced(get_config("llama3-8b+soft"))
    moe = _moe_layer(_specs_for("llama3-8b+soft"), cfg)["moe"]
    assert moe["phi"] == ("data", "model", None)
    assert moe["scale"] == ()


def test_fsdp_off():
    specs = _specs_for("llama3-8b", ShardingOptions(fsdp=False,
                                                    fsdp_min_size=0))
    assert specs["layers"][0]["mlp"]["w_gate"] == (None, "model")


def test_tp_off():
    specs = _specs_for("llama3-8b", ShardingOptions(
        tensor_parallel=False, expert_parallel=False, fsdp_min_size=0))
    assert specs["layers"][0]["mlp"]["w_gate"] == ("data", None)


def _as_spec(mesh, pl, ndim):
    """Placements -> the partition-spec entries they stand for."""
    out = []
    for d in range(ndim):
        axes = tuple(n for n, p in zip(mesh.mesh_dim_names, pl)
                     if p == Shard(d))
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def test_divisibility_fallback():
    """hymba has 25 heads — not divisible by a 4-wide model axis; the
    sharding falls back to replicated on that axis, not crash."""
    cfg = get_config("hymba-1.5b")
    params = abstract_params(build_model(cfg)[0])
    mesh = _mesh((2, 4), ("data", "model"))
    sh = tree_shardings(mesh, params, ShardingOptions())
    wq = sh["layers"][0]["attn"]["wq"]
    assert "model" not in _as_spec(mesh, wq, 3), wq
    assert wq == (Shard(0), Replicate())


JAX_SHARDINGS = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config
from repro.distributed import use_mesh
from repro.distributed.sharding import tree_shardings, ShardingOptions
from repro.models import build_model
out = {}
for name in ("hymba-1.5b", "granite-moe-1b-a400m+soft"):
    params = jax.eval_shape(build_model(get_config(name))[0],
                            jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    for label, shape, axes, dpm in (
            ("2x4", (2, 4), ("data", "model"), False),
            ("2x4 dp_over_model", (2, 4), ("data", "model"), True),
            ("2x2x2", (2, 2, 2), ("pod", "data", "model"), False)):
        mesh = jax.make_mesh(shape, axes)
        with use_mesh(mesh, dp_over_model=dpm):
            sh = treedef.flatten_up_to(
                tree_shardings(mesh, params, ShardingOptions()))
        rows = {}
        for (path, leaf), s in zip(flat, sh):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            sp = [list(e) if isinstance(e, tuple) else e for e in s.spec]
            rows[key] = sp + [None] * (leaf.ndim - len(sp))
        out[name + " " + label] = rows
print("JSON" + json.dumps(out))
"""


def test_tree_shardings_match_jax_on_fake_devices():
    r = subprocess.run(
        [sys.executable, "-c", JAX_SHARDINGS], capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT,
        timeout=300)
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON")]
    assert line, r.stderr[-3000:]
    want_all = json.loads(line[0][4:])
    meshes = {"2x4": ((2, 4), ("data", "model"), False),
              "2x4 dp_over_model": ((2, 4), ("data", "model"), True),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"), False)}
    for name in ("hymba-1.5b", "granite-moe-1b-a400m+soft"):
        cfg = get_config(name)
        params = abstract_params(build_model(cfg)[0])
        leaves = _port_flat(params)
        for label, (shape, axes, dpm) in meshes.items():
            mesh = _mesh(shape, axes)
            with use_mesh(mesh, dp_over_model=dpm):
                sh = tree_shardings(mesh, params, ShardingOptions())
            got = {}
            for path, pl in _port_flat(sh).items():
                got[path] = _as_spec(mesh, pl, leaves[path].ndim)
            jflat = {p: tuple(tuple(e) if isinstance(e, list) else e
                              for e in sp)
                     for p, sp in want_all[f"{name} {label}"].items()}
            want = _to_port_paths(jflat, cfg)
            assert got == want, (name, label)


MESHES = [((1, 1), ("data", "model"), False),
          ((1, 1, 1), ("pod", "data", "model"), False),
          ((1, 1), ("data", "model"), True),
          ((1, 1, 1), ("pod", "data", "model"), True)]


@pytest.mark.parametrize("shape,axes,dpm", MESHES,
                         ids=["data-model", "pod-data-model",
                              "data-model-dp_over_model",
                              "pod-data-model-dp_over_model"])
def test_logical_to_physical_and_spec_match_jax(jx, shape, axes, dpm):
    jmesh = jx.jax.make_mesh(shape, axes)
    mesh = _mesh(shape, axes)
    names = ("batch", "data", "model", "expert", "seq", None)
    with jx.use_mesh(jmesh, dp_over_model=dpm):
        want = [jx.l2p(jmesh, n) for n in names]
        want_spec = tuple(jx.spec("batch", None, "model", "seq"))
    with use_mesh(mesh, dp_over_model=dpm):
        got = [logical_to_physical(mesh, n) for n in names]
        got_spec = spec("batch", None, "model", "seq")
        with pytest.raises(ValueError, match="unknown logical axis"):
            logical_to_physical(mesh, "vocab")
        # a plain tensor passes constrain unchanged (no compiler to hint)
        x = torch.ones(4, 3)
        assert constrain(x, "batch", "model") is x
    assert got == want
    assert got_spec == want_spec
    assert spec("batch") == ()  # no mesh
    pl = batch_sharding(mesh, 3)
    batch_axes = ("pod", "data") if "pod" in axes else ("data",)
    assert pl == tuple(Shard(0) if a in batch_axes else Replicate()
                       for a in axes)
