"""The five ``examples/torch/`` twins run in process on the CPU at small
sizes (``main([..., "--device", "cpu"])``), and their numerics are held
against the reference examples: the contrastive twin's ``info_nce`` and
``text_tower_apply`` against ``examples/contrastive_lit.py``'s, the
quickstart's routing statistics against the JAX ``soft_moe_weights`` /
``soft_moe_apply`` on params converted through ``convert.py``; the serve
twins finish every request."""
import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name):
    return _load(ROOT / "examples" / "torch" / f"{name}.py",
                 f"torch_example_{name}")


def test_train_vit_softmoe_trains_and_resumes(tmp_path, capsys):
    train = _twin("train_vit_softmoe")
    common = ["--batch", "2", "--experts", "2", "--use-kernel",
              "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = train.main(["--steps", "1"] + common)
    assert out["model"] == "soft-moe-s/32-2e"
    assert len(out["losses"]) == 1 and math.isfinite(out["losses"][0])
    # the closing save of step 1 is where a longer run picks up
    out = train.main(["--steps", "2"] + common)
    assert "[trainer] resumed from step 1" in capsys.readouterr().out
    assert len(out["losses"]) == 1 and math.isfinite(out["losses"][0])


def test_quickstart_matches_the_reference_layer(capsys):
    import jax

    from repro.configs.base import MoEConfig
    from repro.core import moe_init, soft_moe_weights
    from repro.core.soft_moe import soft_moe_apply
    from repro_torch.convert import _map, _tensor

    qs = _twin("quickstart")
    out = qs.main(["--device", "cpu"])
    assert out["out_shape"] == (1, 196, 256)
    assert out["params"] == 50_364_417
    assert out["max_combine"] < 1.0
    assert out["llama3_8b_soft"][:2] == ("soft", 128)
    assert "max combine weight" in capsys.readouterr().out

    cfg = MoEConfig(variant="soft", num_experts=128, expert_d_ff=512,
                    slots_per_expert=1)
    params = moe_init(jax.random.PRNGKey(0), 256, cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 196, 256))
    y, metrics = soft_moe_apply(params, cfg, x)
    d_w, _ = soft_moe_weights(x, params["phi"], params["scale"])
    tok, slot = d_w.sum(axis=(2, 3))[0], d_w.sum(axis=1)[0]
    want = {"token_contribution_min": float(tok.min()),
            "token_contribution_max": float(tok.max()),
            "slot_mass_min": float(slot.min()),
            "slot_mass_max": float(slot.max()),
            "max_combine": float(metrics["max_combine"])}
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = qs.routing_stats(_map(tree, lambda a: _tensor(a, "cpu")),
                           torch.from_numpy(np.array(x)))
    assert got["out_shape"] == tuple(y.shape)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k], v)


def test_serve_lm_finishes_every_request():
    serve = _twin("serve_lm")
    for flags in (["--paged", "--shared-prefix", "16"],
                  ["--paged", "--no-kernel", "--spec-k", "2",
                   "--temperature", "0.7", "--top-k", "20"],
                  []):
        out = serve.main(["--device", "cpu", "--requests", "5",
                          "--max-new", "6"] + flags)
        assert all(out["done"]), flags
        assert set(out["finish_reasons"]) <= {"length", "eos"}, flags
        assert out["tokens"] == sum(len(o) for o in out["outputs"])
    assert out["steps"] > 0


def test_serve_async_streams_every_request_and_scrapes_metrics():
    serve = _twin("serve_async")
    out = serve.main(["--device", "cpu", "--paged", "--trace",
                      "--metrics-port", "0", "--requests", "4",
                      "--max-new", "5"])
    assert sorted(out["streams"]) == [0, 1, 2, 3]
    assert all(kind == "streamed" and len(toks) == 5
               for kind, toks in out["streams"].values())
    assert all(r.done for r in out["requests"])
    assert "repro_serve_completed_total 4" in out["metrics_text"]
    # a burst over a tiny budget sheds what it cannot hold, and every
    # admitted request still finishes
    out = serve.main(["--device", "cpu", "--overload", "--max-queue", "2",
                      "--requests", "6", "--max-new", "3"])
    kinds = [kind for kind, _ in out["streams"].values()]
    assert len(kinds) == 6 and "shed" in kinds
    assert all(r.done for r in out["requests"])


def test_contrastive_lit_loss_falls():
    lit = _twin("contrastive_lit")
    losses = lit.main(["--device", "cpu", "--steps", "12",
                       "--batch", "16"])["losses"]
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert all(math.isfinite(v) for v in losses)


def test_contrastive_functions_match_the_reference_example():
    import jax.numpy as jnp

    ref = _load(ROOT / "examples" / "contrastive_lit.py", "ref_lit")
    lit = _twin("contrastive_lit")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((16, 24)).astype(np.float32)
    txt = rng.standard_normal((16, 24)).astype(np.float32)
    want = float(ref.info_nce(jnp.asarray(img), jnp.asarray(txt)))
    got = float(lit.info_nce(torch.from_numpy(img), torch.from_numpy(txt)))
    assert abs(got - want) <= 1e-5 * abs(want)
    params = {"embed": rng.standard_normal((50, 8)).astype(np.float32),
              "proj": rng.standard_normal((8, 24)).astype(np.float32)}
    tokens = rng.integers(1, 50, size=(16, 8))
    want = np.asarray(ref.text_tower_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(tokens)))
    got = lit.text_tower_apply({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(tokens)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
