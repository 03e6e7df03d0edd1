"""End-to-end training script of the PyTorch port, twin of
``examples/train_vit_softmoe.py``: a Soft-MoE ViT (~72M params with
the default 8 experts) on the synthetic image stream, with checkpointing/restart, the straggler
watchdog and the full trainer stack.

  PYTHONPATH=src python examples/torch/train_vit_softmoe.py --steps 300
  python examples/torch/train_vit_softmoe.py --steps 30 --device cpu

The default model is the ViT-S/32 backbone with 8 experts in the second
half of blocks (49-token sequences). ``--router`` switches the routing
algorithm (soft | tokens_choice | experts_choice | identity | uniform |
soft_uniform | uniform_soft) for the paper's Table-3-style comparisons.
``--use-kernel`` routes the Soft-MoE layers through the CUDA kernels
(``models/vit.py::vit_loss(use_kernel=True)``; on CPU tensors their plain
versions); the default is the einsum path, as in the JAX example. The
run is on the card unless ``--device cpu`` is given. A run of fewer
than 10 steps logs every step (the JAX example logs every 10th).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch.configs import soft_moe_vit  # noqa: E402
from repro_torch.data import SyntheticImages  # noqa: E402
from repro_torch.layers.common import resolve_device  # noqa: E402
from repro_torch.models import vit_init, vit_loss  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--router", default="soft")
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_vit_softmoe")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--use-kernel", action="store_true",
                    help="Soft-MoE layers through the CUDA kernels")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = soft_moe_vit("s", 32, args.experts, variant=args.router)
    cfg = dataclasses.replace(cfg, scan_layers=True, remat=False)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  (~{n_params/1e6:.0f}M params, "
          f"{cfg.frontend.num_embeds} tokens)")

    data = SyntheticImages(
        num_patches=cfg.frontend.num_embeds,
        patch_dim=cfg.frontend.embed_dim,
        batch_size=args.batch, num_classes=1000, device=dev,
    )
    tcfg = TrainerConfig(
        total_steps=args.steps, checkpoint_every=100,
        checkpoint_dir=args.ckpt_dir, log_every=min(10, args.steps),
    )
    ocfg = OptimizerConfig(
        peak_lr=args.lr, warmup_steps=20, schedule="rsqrt",
        timescale=100.0, total_steps=args.steps,
        cooldown_steps=max(args.steps // 10, 1),
    )
    trainer = Trainer(
        tcfg, lambda p, b: vit_loss(p, cfg, b, use_kernel=args.use_kernel),
        lambda gen: vit_init(gen, cfg), ocfg, data)
    trainer.run(torch.Generator(device=dev).manual_seed(0))
    hist = trainer.metrics_history
    out = {"model": cfg.name, "params": n_params,
           "losses": [m["total_loss"] for m in hist]}
    if hist:
        out["accuracy"] = hist[-1].get("accuracy", 0)
        print(f"\nloss: {hist[0]['total_loss']:.3f} -> "
              f"{hist[-1]['total_loss']:.3f} over {args.steps} steps; "
              f"acc {out['accuracy']:.3f}")
    return out


if __name__ == "__main__":
    main()
