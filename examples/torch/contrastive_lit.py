"""Paper §4 on the PyTorch port, twin of ``examples/contrastive_lit.py``:
LIT-style contrastive learning — FROZEN Soft-MoE vision tower, text
tower trained from scratch against it (Zhai et al. 2022b).

  PYTHONPATH=src python examples/torch/contrastive_lit.py --steps 200
  python examples/torch/contrastive_lit.py --steps 50 --device cpu

Synthetic paired data: the "caption" tokens are a deterministic function
of the image's latent class, so a working tower pair drives InfoNCE loss
well below ln(batch). The images and captions come from the same numpy
stream as the JAX example's; the towers' weights from a
``torch.Generator``. Runs on the card unless ``--device cpu`` is given."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import reduced, soft_moe_vit  # noqa: E402
from repro_torch.layers.common import lecun_init, resolve_device  # noqa: E402
from repro_torch.models import vit_features, vit_init  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptimizerConfig,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)


def text_tower_init(gen, vocab, d_model, d_out):
    return {
        "embed": 0.02 * torch.randn((vocab, d_model), generator=gen,
                                    device=gen.device),
        "proj": lecun_init(gen, (d_model, d_out), fan_in=d_model),
    }


def text_tower_apply(params, tokens):
    x = params["embed"][tokens].mean(dim=1)  # bag of tokens
    return x @ params["proj"]


def info_nce(img_feats, txt_feats, temp=0.07):
    img = img_feats / torch.linalg.norm(img_feats, dim=-1, keepdim=True)
    txt = txt_feats / torch.linalg.norm(txt_feats, dim=-1, keepdim=True)
    dt = torch.promote_types(img.dtype, txt.dtype)  # as jnp's matmul
    logits = img.to(dt) @ txt.to(dt).T / temp
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -torch.log_softmax(logits, dim=1)[labels, labels].mean()
    lt = -torch.log_softmax(logits, dim=0)[labels, labels].mean()
    return 0.5 * (li + lt)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    vocab, n_classes = 512, 64
    cfg = reduced(soft_moe_vit("s", 16, 8))
    vision_params = vit_init(torch.Generator(device=dev).manual_seed(0), cfg,
                             num_classes=n_classes)  # frozen
    d_feat = cfg.d_model
    text_params = text_tower_init(
        torch.Generator(device=dev).manual_seed(1), vocab, 64, d_feat)
    opt = adamw_init(text_params)
    ocfg = OptimizerConfig(peak_lr=3e-3, schedule="constant",
                           warmup_steps=10, total_steps=10**9,
                           cooldown_steps=1)

    rng_cls = np.random.default_rng(0)
    class_protos = rng_cls.standard_normal(
        (n_classes, cfg.frontend.num_embeds, cfg.frontend.embed_dim)
    ).astype(np.float32)
    class_tokens = rng_cls.integers(1, vocab, size=(n_classes, 8))

    def step(text_params, opt, images, tokens):
        with torch.no_grad():
            img_feats = vit_features(vision_params, cfg, images)  # frozen
        wrt = tree_map(lambda t: t.detach().requires_grad_(), text_params)
        with torch.enable_grad():
            loss = info_nce(img_feats, text_tower_apply(wrt, tokens))
            grads = iter(torch.autograd.grad(loss, tree_leaves(wrt)))
        grads = tree_map(lambda _: next(grads), text_params)
        text_params, opt, _ = adamw_update(grads, opt, text_params, ocfg)
        return text_params, opt, loss.detach()

    losses = []
    for s in range(args.steps):
        cls = rng_cls.choice(n_classes, size=args.batch, replace=False)
        images = torch.as_tensor(
            class_protos[cls]
            + 0.3 * rng_cls.standard_normal(class_protos[cls].shape),
            dtype=torch.float32, device=dev)
        tokens = torch.as_tensor(class_tokens[cls], device=dev)
        text_params, opt, loss = step(text_params, opt, images, tokens)
        losses.append(float(loss))
        if (s + 1) % 25 == 0:
            print(f"step {s+1}: InfoNCE {losses[-1]:.4f} "
                  f"(chance={np.log(args.batch):.3f})")
    assert losses[-1] < losses[0], "contrastive training failed to improve"
    print(f"\nfrozen Soft-MoE tower + trained text tower: "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"losses": losses}


if __name__ == "__main__":
    main()
