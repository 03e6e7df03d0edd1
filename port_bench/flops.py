"""The benchmark's yardstick of work: model FLOPs, kernel bounds, peaks.

Everything here is computed from a configuration file's sizes or from a
call's argument shapes, never from the program's own counts. A FLOP is
one multiply or one add, so a multiply-add is 2.

Model FLOPs count the matrix products a forward pass needs, once each:
- attention: the q, k, v and output projections, and 4·m²·h·hd for the
  scores and the weighted values, halved where the attention is causal
  (the masked half is work the model does not need);
- MLP: 4·d·d_ff a token for the classic fc1-act-fc2 MLP, 6·d·d_ff for
  the gated one;
- Soft MoE: 6·m·d·S a sequence for the logits, the dispatch and the
  combine, plus S times the expert MLP's FLOPs a token;
- the ViT's patch projection and classifier head, the LM's unembedding.
Norms, softmaxes and other elementwise work are left out. A training
step is 3x the forward (forward, and a backward of twice its products);
recomputation under remat is not counted.

A kernel call's bound is the larger of its bytes at the HBM rate (each
input read once, each output written once) and its FLOPs at the dense
tensor-core peak of its lowest-precision floating operand, so no
implementation can read above 100% of it.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 495e12,  # TF32 on the tensor cores
    "float8_e4m3fn": 1979e12,
    "float8_e5m2": 1979e12,
}
BF16_PEAK = PEAK_FLOPS["bfloat16"]
HBM_BYTES_PER_S = 3.35e12


def mlp_flops_per_token(d: int, d_ff: int, style: str) -> float:
    return (6.0 if style == "gated" else 4.0) * d * d_ff


def attention_flops(cfg: dict, m: int) -> float:
    """One layer's attention over one sequence of m tokens."""
    d, h, g, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], \
        cfg["head_dim"]
    proj = 2.0 * m * d * (h * hd + 2 * g * hd) + 2.0 * m * h * hd * d
    core = 4.0 * m * m * h * hd
    if cfg["causal"]:
        core /= 2.0
    return proj + core


def soft_moe_flops(cfg: dict, m: int) -> float:
    """One Soft-MoE layer over one sequence: routing plus the experts."""
    d = cfg["d_model"]
    s = cfg["num_experts"] * cfg["slots_per_expert"]
    return (6.0 * m * d * s
            + s * mlp_flops_per_token(d, cfg["expert_d_ff"], cfg["mlp_style"]))


def forward_flops_per_sequence(cfg: dict, m: int) -> float:
    """One sequence (an image of m patches, or m tokens) through the
    whole model, head included."""
    d = cfg["d_model"]
    moe = set(cfg["moe_layers"])
    total = 0.0
    for i in range(cfg["num_layers"]):
        total += attention_flops(cfg, m)
        if i in moe:
            total += soft_moe_flops(cfg, m)
        else:
            total += m * mlp_flops_per_token(d, cfg["d_ff"], cfg["mlp_style"])
    if cfg["family"] == "vit":
        total += 2.0 * m * cfg["patch_dim"] * d
        total += 2.0 * d * cfg["num_classes"]
    else:
        total += 2.0 * m * d * cfg["vocab_size"]
    return total


def step_flops(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one step of the traffic: a training step over its
    batch, or one inference batch."""
    m = traffic["seq_len"] if cfg["family"] == "lm" else cfg["num_patches"]
    fwd = traffic["batch"] * forward_flops_per_sequence(cfg, m)
    return 3.0 * fwd if traffic["mode"] == "train" else fwd


# --- kernel calls ------------------------------------------------------------


def tensors(tree):
    """The tensors of a nested tuple/list/dict of call arguments."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree] if hasattr(tree, "element_size") else []


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def peak_of(tree) -> float:
    """The dense tensor-core peak of the lowest-precision floating operand."""
    names = [str(t.dtype).replace("torch.", "") for t in tensors(tree)
             if t.is_floating_point()]
    return max(PEAK_FLOPS.get(n, BF16_PEAK) for n in names)


def bound_s(flops: float, bytes_moved: float, peak: float) -> float:
    return max(flops / peak, bytes_moved / HBM_BYTES_PER_S)


# Soft-MoE kernels K1-K6: x (b, m, d) is the first argument, phi_n (d, S)
# the second. Multiples of b·m·d·S:
#  K1 routing:   logits 2, dispatch 2
#  K2/K3 combine: logits 2, combine 2
#  K4 dispatch backward: logits again 2 (only the softmax stats are saved),
#     the dispatch weights' gradient 2, dX through them 2, dX and dPhi_n
#     through the logits 2 + 2
#  K5 combine backward: logits 2, dC 2, dYs 2, dX and dPhi_n 2 + 2
#  K6 routing health: logits 2 (the rest is elementwise)
SOFT_MOE_FLOP_MULTIPLE = {
    "routing_fwd": 4.0,
    "combine_apply": 4.0,
    "combine_online": 4.0,
    "dispatch_bwd": 10.0,
    "combine_bwd": 10.0,
    "routing_health": 2.0,
}


def soft_moe_kernel_bound(kernel: str, args, result) -> float:
    """Seconds one call of Soft-MoE kernel ``kernel`` needs at least."""
    x, phi_n = args[0], args[1]
    b, m, d = x.shape
    s = phi_n.shape[1]
    flops = SOFT_MOE_FLOP_MULTIPLE[kernel] * b * m * d * s
    return bound_s(flops, nbytes(args) + nbytes(result), peak_of(args))


def adamw_bound(grads, mu, nu, params) -> float:
    """Seconds one ``adamw_update`` call needs at least: the global-norm
    clip reads the gradients once, then the update reads gradients,
    params and both moments and writes params and both moments (with f32
    leaves, 32 bytes a parameter)."""
    moved = 2 * nbytes(grads) + 2 * (nbytes(params) + nbytes(mu) + nbytes(nu))
    return moved / HBM_BYTES_PER_S


def param_count(tree) -> int:
    return sum(t.numel() for t in tensors(tree))

