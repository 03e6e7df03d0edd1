"""Quickstart of the PyTorch port, twin of ``examples/quickstart.py``:
the Soft MoE layer in 40 lines.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Builds a Soft MoE layer (paper Algorithm 1+2), runs a forward pass, prints
the routing statistics the paper inspects in §5, and shows the `+soft`
config switch that drops the technique into any assigned architecture.
The layer runs on the card unless ``--device cpu`` is given.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import MoEConfig, get_config  # noqa: E402
from repro_torch.core import moe_init, soft_moe_weights  # noqa: E402
from repro_torch.core.soft_moe import soft_moe_apply  # noqa: E402
from repro_torch.layers.common import resolve_device  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402

D_MODEL, TOKENS = 256, 196  # a ViT-S/16 sequence
CFG = MoEConfig(variant="soft", num_experts=128, expert_d_ff=512,
                slots_per_expert=1)


def routing_stats(params, x):
    """The numbers the quickstart prints, as floats: the layer's output
    shape and max combine weight, each token's total dispatch weight and
    each slot's dispatch mass (min, max)."""
    y, metrics = soft_moe_apply(params, CFG, x)
    d_w, _ = soft_moe_weights(x, params["phi"], params["scale"])
    per_token_total = d_w.sum(dim=(2, 3))[0]  # weight each token sends
    per_slot = d_w.sum(dim=1)[0]
    return {
        "out_shape": tuple(y.shape),
        "token_contribution_min": float(per_token_total.min()),
        "token_contribution_max": float(per_token_total.max()),
        "slot_mass_min": float(per_slot.min()),
        "slot_mass_max": float(per_slot.max()),
        "max_combine": float(metrics["max_combine"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = moe_init(torch.Generator(device=dev).manual_seed(0), D_MODEL,
                      CFG)
    x = torch.randn((1, TOKENS, D_MODEL), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    out = routing_stats(params, x)
    out["params"] = sum(p.numel() for p in tree_leaves(params))
    print(f"in  {tuple(x.shape)} -> out {out['out_shape']}")
    print(f"params: {out['params']:,}")

    # paper §5 model inspection: dispatch/combine weight distributions
    print(f"token contribution to slots: "
          f"min={out['token_contribution_min']:.3f} "
          f"max={out['token_contribution_max']:.3f} (no token dropped)")
    print(f"per-slot dispatch mass: {out['slot_mass_min']:.3f}..."
          f"{out['slot_mass_max']:.3f} (balanced by construction)")
    print(f"max combine weight: {out['max_combine']:.3f} "
          f"(<1.0: no softmax collapse — Algorithm 2 L2 norm)")

    # the technique as a first-class feature on an assigned arch
    cfg72 = get_config("llama3-8b+soft")
    out["llama3_8b_soft"] = (cfg72.moe.variant, cfg72.moe.num_experts,
                             cfg72.moe_layer_indices()[:3])
    print(f"\nllama3-8b+soft: moe variant={cfg72.moe.variant}, "
          f"{cfg72.moe.num_experts} experts in layers "
          f"{cfg72.moe_layer_indices()[:3]}...")
    return out


if __name__ == "__main__":
    main()
