"""What the benchmark takes from the program (``repro_torch``): the model
configuration, the train step and the inference call.

Modules are looked up at call time (``vit_mod.vit_loss``, not a name
bound at import), so a test can plant a fault in the program underneath a
whole run.
"""
from __future__ import annotations

import dataclasses


def port_config(cfg: dict):
    """The port's ModelConfig named by the configuration file, with the
    file's sizes. For the benchmark's own files this is exactly
    ``get_config(cfg["program"])`` (a CPU test holds it so); smaller
    sizes serve the CPU tests."""
    from repro_torch.configs import get_config

    base = get_config(cfg["program"])
    attn = dataclasses.replace(
        base.attention, num_heads=cfg["num_heads"],
        num_kv_heads=cfg["num_kv_heads"], head_dim=cfg["head_dim"],
        rope_theta=cfg["rope_theta"])
    expert_d_ff = cfg["expert_d_ff"]
    if base.moe.expert_d_ff == 0 and expert_d_ff == cfg["d_ff"]:
        expert_d_ff = 0  # the port's "inherit the model's d_ff"
    moe = dataclasses.replace(
        base.moe, num_experts=cfg["num_experts"],
        slots_per_expert=cfg["slots_per_expert"], expert_d_ff=expert_d_ff)
    out = dataclasses.replace(
        base, num_layers=cfg["num_layers"], d_model=cfg["d_model"],
        d_ff=cfg["d_ff"], attention=attn, moe=moe,
        mlp_style=cfg["mlp_style"], norm=cfg["norm"], causal=cfg["causal"],
        act="gelu" if cfg["act"] == "gelu_tanh" else cfg["act"],
        dtype=cfg["dtype"], param_dtype=cfg["param_dtype"])
    if cfg["family"] == "vit":
        out = dataclasses.replace(
            out, max_seq_len=cfg["num_patches"],
            frontend=dataclasses.replace(base.frontend,
                                         embed_dim=cfg["patch_dim"],
                                         num_embeds=cfg["num_patches"]))
    else:
        out = dataclasses.replace(out, vocab_size=cfg["vocab_size"],
                                  tie_embeddings=cfg["tie_embeddings"])
    if tuple(out.moe_layer_indices()) != tuple(cfg["moe_layers"]):
        out = dataclasses.replace(
            out, moe_layers=",".join(str(i) for i in cfg["moe_layers"]))
    return out


def params_tree(spec, flat):
    """The port's parameter tree over views of the flat weights."""
    from .reference.model import tree
    from .reference.spec import views

    return tree(spec, views(spec, flat))


def make_train_step(cfg: dict, pcfg, traffic: dict):
    """The port's step on the cell's loss: ``step(state, batch) -> (state,
    metrics)``, updating the state in place."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import step as step_mod

    opt = OptimizerConfig(**traffic["optimizer"])
    if cfg["family"] == "vit":
        from repro_torch.models import vit as vit_mod

        def loss_fn(p, b):
            return vit_mod.vit_loss(p, pcfg, b, use_kernel=True)
    else:
        from repro_torch.models import lm as lm_mod
        telemetry = traffic.get("telemetry", False)

        def loss_fn(p, b):
            return lm_mod.lm_loss(p, pcfg, b, use_kernel=True,
                                  telemetry=telemetry)
    return step_mod.make_train_step(loss_fn, opt)


def init_state(params):
    """The port's train state (f32 params, zero AdamW moments)."""
    from repro_torch.train import step as step_mod

    return step_mod.init_train_state(None, lambda _gen: params)


def make_infer(pcfg):
    """``infer(params, patches) -> logits`` on the port's kernel path."""
    from repro_torch.models import vit as vit_mod

    def infer(params, patches):
        return vit_mod.vit_apply(params, pcfg, patches, use_kernel=True)[0]

    return infer

