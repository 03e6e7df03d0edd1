"""All-to-all expert-parallel token routing, counterpart of
``repro/distributed/a2a_routing.py``.

Each rank holds a token shard, decides expert assignments locally, and
exchanges exactly the routed token payload with the expert-owner ranks:
per rank about tokens x top_k x d values each way per layer. The
exchange has a fixed per-destination capacity, ``max(int(cf * top_k * t
/ nd), 1)``; overflow (token, choice) pairs drop exactly like
capacity-constrained tokens-choice:

  1. per rank: bucket local tokens by destination rank
     (expert_id // experts_per_rank) into (ranks, cap, d) send buffers;
  2. ``all_to_all_single`` exchanges the buffers over the `model` group;
  3. each rank applies its LOCAL experts to every received row and keeps
     the rows meant for each (the reference's masked meaning);
  4. a second ``all_to_all_single`` returns the outputs; combine with the
     gate weights.

The router logits are the sparse layers' own (``kernels.invariant_matmul.
router_logits``: the fixed-order kernel on the card, the plain product
elsewhere). As in the reference, the train step does not route through it (the
reference leaves that integration as its next step).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.invariant_matmul import router_logits
from .api import current_mesh


def _bucket_by_device(x, expert_idx, gate, num_devices: int,
                      experts_per_device: int, cap: int):
    """x: (t, d) local tokens; expert_idx/gate: (t, k). Returns send
    buffers (devices, cap, d), their (local) expert slots (devices, cap),
    a validity mask (devices, cap) and, for the return trip, each (token,
    choice)'s (destination, position, kept)."""
    t, d = x.shape
    k = expert_idx.shape[1]
    dest = expert_idx // experts_per_device  # (t, k) device id
    local_e = expert_idx % experts_per_device
    flat_dest = dest.reshape(-1)
    # position of each (token, choice) within its destination bucket
    onehot = F.one_hot(flat_dest, num_devices).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = (pos * onehot).sum(-1)  # (t*k,)
    keep = pos < cap
    pos_c = torch.clamp(pos, 0, cap - 1).long()

    # dropped pairs all land on slot cap-1 and add zeros there
    send = torch.zeros((num_devices, cap, d), dtype=x.dtype, device=x.device)
    send.index_put_(
        (flat_dest, pos_c),
        torch.where(keep[:, None], x.repeat_interleave(k, dim=0),
                    torch.zeros((), dtype=x.dtype, device=x.device)),
        accumulate=True)
    flat = flat_dest * cap + pos_c
    send_e = torch.zeros(num_devices * cap, dtype=torch.int32,
                         device=x.device)
    send_e.scatter_reduce_(
        0, flat, torch.where(keep, local_e.reshape(-1).to(torch.int32), 0),
        reduce="amax")
    valid = torch.zeros(num_devices * cap, dtype=torch.int32,
                        device=x.device)
    valid.scatter_reduce_(0, flat, keep.to(torch.int32), reduce="amax")
    return (send, send_e.view(num_devices, cap),
            valid.view(num_devices, cap).bool(), (flat_dest, pos_c, keep))


def _all_to_all(t, group):
    """(devices, ...) -> (devices, ...) whose axis 0 indexes the source
    rank, as ``jax.lax.all_to_all(t, axis, 0, 0, tiled=False)``."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def a2a_route_and_compute(x, router_w, expert_fn, *, axis_name: str,
                          num_experts: int, top_k: int,
                          capacity_factor: float = 2.0, mesh=None):
    """x (t_local, d): this rank's token shard; router_w (d, E) the same
    on every rank; expert_fn(local_expert_id, tokens) applies THIS rank's
    expert. The exchange runs on the group of mesh dimension
    ``axis_name`` of ``mesh`` (the current mesh when None). Returns
    (t_local, d) combined outputs."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("a2a_route_and_compute needs a mesh")
    group = mesh.get_group(axis_name)
    nd = dist.get_world_size(group)
    epd = num_experts // nd
    t, d = x.shape
    cap = max(int(capacity_factor * top_k * t / nd), 1)

    # the sparse layers' router: the fixed-order kernel on the card
    logits = router_logits(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the larger first, ties to the lower index (a stable sort)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = order.values[:, :top_k], order.indices[:, :top_k]

    send, send_e, valid, (flat_dest, pos_c, keep) = _bucket_by_device(
        x, expert_idx, gate, nd, epd, cap)
    # exchange: (devices, cap, d) -> received (devices, cap, d), where
    # axis 0 now indexes the SOURCE rank. The mask travels as uint8: not
    # every backend carries bool.
    recv = _all_to_all(send, group)
    recv_e = _all_to_all(send_e, group)
    recv_v = _all_to_all(valid.to(torch.uint8), group).bool()

    # apply local experts: mask per local expert id
    flat = recv.reshape(nd * cap, d)
    fe = recv_e.reshape(-1)
    fv = recv_v.reshape(-1)
    acc = torch.zeros_like(flat)
    for le in range(epd):
        sel = (fe == le) & fv
        y = expert_fn(le, flat)
        acc = acc + torch.where(sel[:, None], y, 0)
    out = acc.reshape(nd, cap, d)

    # return trip
    back = _all_to_all(out, group)
    # combine: gather each (token, choice)'s output and weight by gate
    flat_out = back[flat_dest, pos_c]  # (t*k, d)
    flat_out = torch.where(keep[:, None], flat_out, 0)
    gate_n = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    y = (flat_out.reshape(t, top_k, d)
         * gate_n[..., None].to(flat_out.dtype)).sum(1)
    return y.to(x.dtype)


def make_a2a_moe(mesh, num_experts: int, top_k: int, d_model: int,
                 capacity_factor: float = 2.0, axis_name: str = "model"):
    """The MoE layer over ``mesh``: ``fn(x, router_w, expert_gate,
    expert_up, expert_down)`` takes this rank's token shard (t_local, d),
    the router (d, E) and this rank's experts (E / ranks, d, ff) etc.,
    the local blocks of the reference's ``shard_map`` in_specs (tokens
    and experts over ``axis_name``, the router replicated), and returns
    this rank's (t_local, d) outputs."""

    def fn(x, router_w, expert_gate, expert_up, expert_down):
        def expert_fn(le, toks):
            g = F.silu(toks @ expert_gate[le].to(toks.dtype))
            u = toks @ expert_up[le].to(toks.dtype)
            return (g * u) @ expert_down[le].to(toks.dtype)

        return a2a_route_and_compute(
            x, router_w, expert_fn, axis_name=axis_name,
            num_experts=num_experts, top_k=top_k,
            capacity_factor=capacity_factor, mesh=mesh)

    return fn
