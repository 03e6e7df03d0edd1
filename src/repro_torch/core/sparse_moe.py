"""The sparse MoE baselines the paper compares against (section 3.2),
counterpart of ``repro/core/sparse_moe.py``:

  * Tokens Choice: each token picks its top-K experts (Shazeer et al.
    2017), with Batch Priority Routing (Riquelme et al. 2021) optional,
    into per-expert capacity buffers;
  * Experts Choice: each expert picks its top-C tokens (Zhou et al. 2022).

Both route through (experts, capacity, d) buffers, never a (tokens x
experts x capacity) one-hot tensor, so memory stays linear. They are
also the native routers of granite-moe-1b-a400m (top-8 of 32) and
deepseek-v2-lite (top-6 of 64).

Routing scope depends on the mode, as in the reference. ``mode="train"``
(or ``MoEConfig.batch_coupled``) routes groups of ``group_size``
sequences together, competing for per-call capacity (the paper's section
3.5 setting). The serving modes (``"prefill"``, ``"decode"``) route each
row alone with the dropless budget ``capacity = tokens in this call``,
so a request's outputs never depend on its batch neighbours or on how
its prompt was chunked (``serve.telemetry.batch_variance_probe``
measures this).

Every group is routed at once: no Python loop over groups, no host sync
(no ``nonzero``, no ``.item()``), capacities are Python ints taken from
shapes. Choices are ordered as ``jax.lax.top_k`` orders them (descending,
ties to the lower index) by a stable descending sort. Sums that several
writers share run in a fixed order, so the card gives the same bits run
to run: see ``_GatherRows`` and ``_ScatterSumRows``.
"""
from __future__ import annotations

import torch

from ..kernels.invariant_matmul import router_logits
from ..layers.common import lecun_init
from ..layers.mlp import expert_init, experts_apply


def sparse_moe_init(gen: torch.Generator, d_model: int, moe_cfg,
                    style: str = "gated"):
    e, d_ff = moe_cfg.num_experts, moe_cfg.expert_d_ff
    params = {
        "router": lecun_init(gen, (d_model, e), fan_in=d_model),
        "experts": expert_init(gen, e, d_model, d_ff, style),
    }
    if moe_cfg.num_shared_experts:
        params["shared"] = expert_init(gen, moe_cfg.num_shared_experts,
                                       d_model, d_ff, style)
    return params


def _router_logits(params, x):
    """(g, t, d) -> (g, t, e) router logits, in f32 from f32 weights,
    through the fixed-order kernel in every mode: a row's logits do not
    depend on how many rows the call holds, so serving stays batch
    invariant on the card and ``batch_coupled`` serving equals
    ``mode="train"`` bitwise."""
    return router_logits(x.float(), params["router"].float())


def _routing_scope(moe_cfg, mode: str, b: int, m: int):
    """(coupled, gs): coupled group routing spans ``group_size``
    sequences and sizes buffers by ``capacity_factor`` (tokens compete,
    overflow drops); per-row serving routing fixes the group at one
    sequence and the budget at the dropless bound."""
    coupled = moe_cfg.batch_coupled or mode == "train"
    gs = max(1, min(moe_cfg.group_size, b)) if coupled else 1
    return coupled, gs


def _top_k(scores, k: int):
    """``jax.lax.top_k`` over the last axis: values in descending order,
    equal values in index order (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(index, weights, n: int):
    """Per-bin sums of ``weights`` over ``index`` (any shape) into (n,)
    f32. The weights are 0 or 1, so the sums are exact integers and the
    order of the additions cannot change them."""
    out = torch.zeros(n, dtype=torch.float32, device=index.device)
    return out.scatter_add_(0, index.reshape(-1), weights.reshape(-1).float())


def _aux_losses(logits, probs, expert_index, num_experts, moe_cfg):
    """Switch-style load-balance loss plus the router z-loss."""
    g, t = expert_index.shape[:2]
    first = expert_index[..., 0]
    frac_tokens = _counts(first, torch.ones_like(first), num_experts) / (g * t)
    frac_probs = probs.mean(dim=(0, 1))
    balance = num_experts * torch.sum(frac_tokens * frac_probs)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return (moe_cfg.aux_loss_weight * balance
            + moe_cfg.router_z_loss_weight * z)


def _router_telemetry(probs):
    """Router health: ({"router_entropy", "max_router_prob"}, per-token
    entropy (g, t))."""
    ent = -torch.where(probs > 0,
                       probs * torch.log(torch.clamp(probs, min=1e-30)),
                       0.0).sum(-1)
    return {"router_entropy": ent.mean().float(),
            "max_router_prob": probs.max().float()}, ent


def _per_row(v, g, gs, m):
    """(g, gs * m, ...) -> (b,) mean over each sequence's tokens."""
    return v.reshape(g, gs, m, -1).float().mean(dim=(2, 3)).reshape(-1)


def _detached(tree):
    return {k: _detached(v) if isinstance(v, dict) else v.detach().float()
            for k, v in tree.items()}


def _tokens_choice_route(probs, moe_cfg, coupled: bool):
    """probs (g, t, e) -> (gate_n, expert_index, pos, keep, capacity):
    each token's top-k experts (g, t, k), their renormalized kept gates,
    each choice's position in its expert's buffer and whether it fits."""
    g, t, e = probs.shape
    k = moe_cfg.top_k
    gate, expert_index = _top_k(probs, k)  # (g, t, k)
    if coupled:
        capacity = max(int(moe_cfg.capacity_factor * k * t / e), 1)
    else:
        # dropless per-request budget: a token's k experts are distinct,
        # so one expert takes at most t choices of one row
        capacity = t

    # Priority over tokens: BPR by max router prob (descending), else
    # positional. The order is discrete: it takes no gradient.
    if moe_cfg.bpr and coupled:
        priority = torch.argsort(-gate[..., 0].detach(), dim=-1, stable=True)
    else:
        priority = torch.arange(t, device=probs.device).expand(g, t)
    inv = torch.argsort(priority, dim=-1, stable=True)  # rank of each token

    # position of each (token, choice) in its expert's buffer, counted in
    # priority order; a choice past capacity is dropped. A stable sort of
    # the choices (priority order, then choice order) by expert keeps
    # that order within each expert, so a choice's position is its index
    # in the sorted row less the number of choices of lower experts.
    flat = torch.gather(expert_index, 1,
                        priority[..., None].expand(g, t, k)).reshape(g, t * k)
    experts, by_expert = torch.sort(flat, dim=-1, stable=True)
    counts = torch.zeros(g, e, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    start = torch.cumsum(counts, dim=-1) - counts  # (g, e)
    rank = (torch.arange(t * k, device=flat.device)
            - torch.gather(start, 1, experts))
    pos = torch.empty_like(rank).scatter_(1, by_expert, rank)
    pos = torch.gather(pos.reshape(g, t, k), 1,
                       inv[..., None].expand(g, t, k))
    keep = pos < capacity  # (g, t, k); all True on the dropless path

    gate = gate * keep
    gate_n = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate_n, expert_index, pos, keep, capacity


def tokens_choice_apply(params, moe_cfg, x, act: str = "silu",
                        telemetry: bool = False, mode: str = "train"):
    """Top-K token-choice routing. x: (b, m, d) -> (y, metrics).

    ``metrics``: ``moe_aux_loss`` (balance + z-loss) and
    ``dropped_fraction`` (tokens whose every choice overflowed). With
    ``telemetry`` also ``metrics["telemetry"]``: router entropy and
    confidence, the per-expert load spread over the kept choices, the
    kept and dropped fractions, and per-row (b,) ``rows``, all detached
    f32; ``y`` is the same either way.

    Dispatch: each kept (token, choice) owns one slot of its expert's
    buffer (its position counts the expert's earlier choices in priority
    order), so the buffer is written by a copy to distinct rows. Every
    dropped choice goes to one spare row past the buffers, cut off
    before the experts run: it can never overwrite the kept token that
    owns the last slot (the reference adds a zero there instead)."""
    b, m, d = x.shape
    coupled, gs = _routing_scope(moe_cfg, mode, b, m)
    g, t = b // gs, gs * m
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    xg = x.reshape(g, t, d)

    logits = _router_logits(params, xg)  # (g, t, e)
    probs = torch.softmax(logits, dim=-1)
    gate_n, expert_index, pos, keep, capacity = _tokens_choice_route(
        probs, moe_cfg, coupled)

    # buffers laid out (e, g, capacity) so the experts read one
    # contiguous (e, g * capacity, d) view; row n_rows is the spare
    n_rows = e * g * capacity
    group = torch.arange(g, device=x.device)[:, None, None]
    row = torch.where(keep, (expert_index * g + group) * capacity + pos,
                      n_rows).reshape(-1)  # (g t k,)
    src = xg[:, :, None, :].expand(g, t, k, d).reshape(g * t * k, d)
    buf = x.new_zeros((n_rows + 1, d)).index_copy(0, row, src)
    out = experts_apply(params["experts"], buf[:n_rows].view(e, g * capacity,
                                                             d), act)
    y = _TakeRows.apply(out.reshape(n_rows, d), row).reshape(g, t, k, d)
    y = (y * gate_n[..., None]).sum(2)
    y = y.reshape(b, m, d).to(x.dtype)

    if moe_cfg.num_shared_experts:
        # one leading-1 expert axis, broadcast by experts_apply
        sh = experts_apply(params["shared"], x.reshape(1, b * m, d), act)
        # the shared experts' sum accumulates in f32, as jnp.sum does
        sh = sh.sum(0, dtype=torch.float32).to(sh.dtype)
        y = y + sh.reshape(b, m, d).to(x.dtype)

    aux = _aux_losses(logits, probs, expert_index, e, moe_cfg)
    # per-row fully-dropped token fraction (b,); the scalar is its mean
    dropped_rows = 1.0 - _per_row(keep.any(dim=-1), g, gs, m)
    dropped = dropped_rows.mean()
    metrics = {"moe_aux_loss": aux, "dropped_fraction": dropped}
    if telemetry:
        # per-expert load over the KEPT choices: the outcome of the
        # capacity competition that the batch-variance probe watches
        load = _counts(expert_index, keep, e)
        scalars, ent = _router_telemetry(probs.detach())
        metrics["telemetry"] = _detached({
            **scalars,
            "expert_load_spread": load.max() / torch.clamp(load.min(),
                                                           min=1e-9),
            "kept_fraction": keep.float().mean(),
            "dropped_fraction": dropped,
            "rows": {
                "router_entropy": _per_row(ent, g, gs, m),
                "kept_fraction": _per_row(keep, g, gs, m),
                "dropped_fraction": dropped_rows,
            },
        })
    return y, metrics


class _TakeRows(torch.autograd.Function):
    """``src[idx]`` for src (n, d) and idx (c,) in [0, n], where n (one
    past the end) reads a zero row and each row below n is read at most
    once. Its backward gathers through the inverse map: the index_add
    of a plain gather's backward would serialize on the spare row that
    every dropped choice reads."""

    @staticmethod
    def forward(ctx, src, idx):
        n, d = src.shape
        c = idx.shape[0]
        inv = torch.full((n + 1,), c, dtype=idx.dtype, device=idx.device)
        inv.scatter_(0, idx, torch.arange(c, device=idx.device))
        ctx.save_for_backward(inv[:n])
        return torch.cat([src, src.new_zeros((1, d))]).index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        ext = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return ext.index_select(0, inv), None


class _GatherRows(torch.autograd.Function):
    """``rows[i, j] = x[idx[i, j]]`` for x (n, d) and idx (e, c), each
    ``idx[i]`` distinct. Its backward sums a row's gradients expert by
    expert, in expert order (``_ScatterSumRows``): one accumulating
    scatter over all (i, j) would race on a row that several experts
    took, and give other bits on each run."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _ScatterSumRows.apply(grad, idx, ctx.n).to(grad.dtype), None


class _ScatterSumRows(torch.autograd.Function):
    """``out[r] = sum over i (in order) of src[i, j] where idx[i, j] = r``
    in f32; the adjoint of ``_GatherRows``."""

    @staticmethod
    def forward(ctx, src, idx, n):
        ctx.save_for_backward(idx)
        ctx.dtype = src.dtype
        out = src.new_zeros((n, src.shape[-1]), dtype=torch.float32)
        for i in range(idx.shape[0]):  # distinct rows within one expert
            out.index_add_(0, idx[i], src[i].float())
        return out

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad[idx].to(ctx.dtype), None, None


def experts_choice_apply(params, moe_cfg, x, act: str = "silu",
                         telemetry: bool = False, mode: str = "train"):
    """Experts-Choice routing: each expert takes its top-C tokens. x:
    (b, m, d) -> (y, metrics), ``metrics`` as in
    :func:`tokens_choice_apply` (no ``expert_load_spread``: each expert
    takes exactly C tokens).

    Serving modes select within one row with the dropless budget C =
    tokens in this call: every expert then takes every token of the row,
    weighted by its router prob (the continuous limit of Experts Choice,
    the one member of its family that does not depend on the batch).
    ``mode="train"`` / ``batch_coupled`` keep the paper's competitive
    top-C selection. A token that several experts took sums their
    outputs in expert order, in f32 (the reference's CPU scatter adds in
    that order)."""
    b, m, d = x.shape
    coupled, gs = _routing_scope(moe_cfg, mode, b, m)
    g, t = b // gs, gs * m
    e = moe_cfg.num_experts
    xg = x.reshape(g, t, d)

    logits = _router_logits(params, xg)  # (g, t, e)
    probs = torch.softmax(logits, dim=-1)
    if coupled:
        capacity = max(int(moe_cfg.capacity_factor * t / e), 1)
    else:
        capacity = t  # dropless: every expert can take the whole row

    gsc, tidx = _top_k(probs.transpose(1, 2), capacity)  # (g, e, cap)

    # rows of the flattened (g t, d) tokens, laid out (e, g cap)
    flat = (tidx + t * torch.arange(g, device=x.device)[:, None, None])
    flat = flat.transpose(0, 1).reshape(e, g * capacity)
    gathered = _GatherRows.apply(x.reshape(g * t, d), flat)
    out = experts_apply(params["experts"], gathered, act)  # (e, g cap, d)
    out = out * gsc.transpose(0, 1).reshape(e, g * capacity, 1).to(out.dtype)
    y = _ScatterSumRows.apply(out, flat, g * t).to(out.dtype)
    y = y.reshape(b, m, d).to(x.dtype)

    aux = moe_cfg.router_z_loss_weight * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    # dropped = tokens no expert selected (paper App. B), per row
    selected = torch.zeros(g, t, dtype=torch.bool, device=x.device)
    selected.scatter_(1, tidx.reshape(g, e * capacity), True)
    selected_rows = _per_row(selected, g, gs, m)
    metrics = {"moe_aux_loss": aux,
               "dropped_fraction": 1.0 - selected_rows.mean()}
    if telemetry:
        # expert load is uniform by construction; token coverage is the
        # health signal instead
        scalars, ent = _router_telemetry(probs.detach())
        metrics["telemetry"] = _detached({
            **scalars,
            "kept_fraction": selected_rows.mean(),
            "dropped_fraction": 1.0 - selected_rows.mean(),
            "rows": {
                "router_entropy": _per_row(ent, g, gs, m),
                "kept_fraction": selected_rows,
                "dropped_fraction": 1.0 - selected_rows,
            },
        })
    return y, metrics
