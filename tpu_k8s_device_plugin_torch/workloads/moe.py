"""Mixture-of-experts FFN: top-k routing with a fixed per-expert capacity.

The JAX package's ``workloads/moe.py`` in PyTorch, with the same
parameters under the same names and layouts (``router [D, E]``,
``experts_up [E, D, F]``, ``experts_down [E, F, D]``, or their int8 forms
with per-(expert, out-channel) f32 scales), so a converted tree loads
leaf for leaf:

* dense dispatch: every token's (token, choice) routes claim capacity
  slots of their expert in token order (or in the order of an explicit
  ``priority``, the positions), a route beyond the expert's capacity is
  dropped and rides the residual, and one-hot dispatch and combine
  tensors turn the routing into batched einsums of static shape;
* the router runs in f32 (softmax, top-k, renormalised gates); the
  expert matmuls run in the compute dtype; the combine is an f32
  contraction;
* one token a row (T == 1) with ``B * k <= E`` takes the gather branch:
  only the routed experts' stacks are read, which is exactly the dense
  result (a single token never overflows);
* the Switch load-balancing loss ``E * sum_e frac(e) * mean_prob(e)``
  (1.0 at perfect balance) is kept on the module after each forward,
  scaled by ``aux_weight`` (``aux``), where flax sows it; the training
  loss adds up every expert layer's term (``transformer.lm_loss``).

The top-k is a stable descending sort, so ties go to the lower expert
index, as ``jax.lax.top_k`` breaks them.  No kernel of its own: the
JAX package leaves these einsums to XLA.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import COMPUTE_DTYPE, resolve_device


def moe_capacity(tokens: int, n_experts: int, k: int,
                 capacity_factor: float) -> int:
    """Per-expert capacity slots: ceil(k * T / E * factor), at least 1."""
    return max(1, math.ceil(k * tokens / n_experts * capacity_factor))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_gates(router_logits: torch.Tensor, k: int):
    """Softmax probabilities in f32, the top-k experts and their gates
    renormalised to sum to 1 per token: shared by the dense plan and the
    gather branch, so the two agree."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
              k: int) -> torch.Tensor:
    """Switch load-balancing loss from the probabilities and the chosen
    experts: E * sum_e route-fraction(e) * mean-prob(e)."""
    E = probs.shape[-1]
    choice = F.one_hot(gate_idx, E).to(torch.float32)
    route_frac = choice.sum(dim=2).mean(dim=(0, 1)) / k
    prob_mean = probs.mean(dim=(0, 1))
    return E * (route_frac * prob_mean).sum()


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int,
                  priority: Optional[torch.Tensor] = None):
    """Dense top-k dispatch plan from router logits [B, T, E].

    Returns ``(dispatch, combine, aux_loss)``: ``dispatch`` [B, T, E, C]
    is one where token t holds capacity slot c of expert e (at most k a
    token, fewer when an expert overflows), ``combine`` is the same
    weighted by the token's renormalised gate for that expert (f32), and
    ``aux_loss`` the Switch loss.  Slots go in token order, a token's
    earlier choice first; *priority* [B, T] overrides the token order
    (lower claims first), so the LM's positions make the dropped tokens
    independent of the storage layout."""
    dispatch, combine, probs, gate_idx = _plan(router_logits, k, capacity,
                                               priority)
    return dispatch, combine, _aux_loss(probs, gate_idx, k)


def _plan(router_logits: torch.Tensor, k: int, capacity: int,
          priority: Optional[torch.Tensor] = None):
    """:func:`top_k_routing`'s dispatch and combine, with the
    probabilities and chosen experts its aux loss is made from."""
    B, T, E = router_logits.shape
    probs, gate_vals, gate_idx = _top_k_gates(router_logits, k)
    choice = F.one_hot(gate_idx, E).to(torch.float32)  # [B, T, k, E]
    if priority is not None:
        # queue positions in priority order, scattered back to storage
        # order (both sorts stable, as jnp.argsort is)
        order = torch.argsort(priority, dim=1, stable=True)
        inv = torch.argsort(order, dim=1, stable=True)

        def by_token(a, idx):
            return torch.take_along_dim(a, idx[:, :, None, None], dim=1)

        flat_sorted = by_token(choice, order).reshape(B, T * k, E)
        pos_sorted = torch.cumsum(flat_sorted, dim=1) - flat_sorted
        pos = by_token(pos_sorted.reshape(B, T, k, E),
                       inv).reshape(B, T * k, E)
    else:
        flat_sorted = choice.reshape(B, T * k, E)
        pos = torch.cumsum(flat_sorted, dim=1) - flat_sorted
    flat = choice.reshape(B, T * k, E)
    # each route targets one expert: reduce E out before the capacity
    # one-hot, so the intermediate is [B, T, k, C]
    pos_route = (pos * flat).sum(dim=-1)                 # [B, T*k]
    kept = ((pos < capacity).to(torch.float32) * flat).sum(dim=-1)
    # jax.nn.one_hot gives a zero row past the last class; torch raises,
    # so the index is clamped and the dropped route zeroed by `kept`
    slot = F.one_hot(pos_route.to(torch.int64).clamp(max=capacity - 1),
                     capacity).to(torch.float32)
    slot_route = (slot * kept[..., None]).reshape(B, T, k, capacity)
    dispatch = torch.einsum("btke,btkc->btec", choice, slot_route)
    combine = torch.einsum("btke,btkc->btec", choice,
                           slot_route * gate_vals[..., None])
    return dispatch, combine, probs, gate_idx


class MoEFFN(nn.Module):
    """Top-k routed expert FFN, ``[B, T, D] -> [B, T, D]``, in place of
    a block's dense MLP: each expert is a GELU MLP (tanh form, flax's
    ``nn.gelu``) ``down(gelu(up(x)))``.

    Parameters: ``router [D, E]`` f32 always; the expert stacks in
    *param_dtype* (``experts_up [E, D, F]``, ``experts_down [E, F, D]``),
    or with ``quantized`` int8 stacks ``experts_*_int8`` and f32 scales
    ``experts_up_scale [E, F]`` / ``experts_down_scale [E, D]`` applied
    to the dot outputs.  Left uninitialised: load or fill them.  After
    each forward ``aux`` holds ``aux_weight`` times the Switch loss
    (``keep_aux`` off skips it, as the serving model does)."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int, k: int = 2,
                 capacity_factor: float = 1.25,
                 capacity: Optional[int] = None, aux_weight: float = 1e-2,
                 dtype: torch.dtype = COMPUTE_DTYPE, quantized=False,
                 device=None, param_dtype: torch.dtype = torch.float32,
                 keep_aux: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.n_experts, self.d_model, self.d_ff = n_experts, d_model, d_ff
        self.k, self.capacity_factor = k, capacity_factor
        self.capacity, self.aux_weight = capacity, aux_weight
        self.dtype, self.quantized = dtype, bool(quantized)
        self.keep_aux = keep_aux
        self.aux: Optional[torch.Tensor] = None
        E, D, Fd = n_experts, d_model, d_ff
        self.router = nn.Parameter(torch.empty(
            D, E, dtype=torch.float32, device=device))
        if not self.quantized:
            self.experts_up = nn.Parameter(torch.empty(
                E, D, Fd, dtype=param_dtype, device=device))
            self.experts_down = nn.Parameter(torch.empty(
                E, Fd, D, dtype=param_dtype, device=device))
        else:
            def frozen(shape, dt):
                return nn.Parameter(torch.empty(shape, dtype=dt,
                                                device=device),
                                    requires_grad=False)

            self.experts_up_int8 = frozen((E, D, Fd), torch.int8)
            self.experts_down_int8 = frozen((E, Fd, D), torch.int8)
            self.experts_up_scale = frozen((E, Fd), torch.float32)
            self.experts_down_scale = frozen((E, D), torch.float32)

    def _weights(self):
        """(w_up, w_down, up_scale, down_scale); scales None unquantized."""
        if not self.quantized:
            return self.experts_up, self.experts_down, None, None
        return (self.experts_up_int8, self.experts_down_int8,
                self.experts_up_scale, self.experts_down_scale)

    def _keep(self, aux: torch.Tensor) -> None:
        if self.keep_aux:
            self.aux = self.aux_weight * aux

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                capacity: Optional[int] = None) -> torch.Tensor:
        """*capacity* overrides the module's for this call (the serving
        extend pins it to T, which never drops)."""
        B, T, D = x.shape
        E, k, dt = self.n_experts, self.k, self.dtype
        cap = capacity if capacity is not None else self.capacity
        if cap is None:
            cap = moe_capacity(T, E, k, self.capacity_factor)
        logits = torch.einsum("btd,de->bte", x.to(torch.float32),
                              self.router)
        w_up, w_down, up_scale, down_scale = self._weights()

        if T == 1 and B * k <= E:
            # one token a row: gather only the k routed experts' stacks
            # (dropless at T == 1, so exactly the dense result); taken
            # while B*k <= E, past which the gathered copies [B, k, D, F]
            # outweigh the dense read
            probs, gate_vals, gate_idx = _top_k_gates(logits, k)
            self._keep(_aux_loss(probs, gate_idx, k))
            idx = gate_idx[:, 0]                        # [B, k]
            up_sel = w_up[idx].to(dt)                   # [B, k, D, F]
            down_sel = w_down[idx].to(dt)               # [B, k, F, D]
            h = torch.einsum("bd,bkdf->bkf", x[:, 0].to(dt), up_sel)
            if up_scale is not None:  # dequantised on the dot output
                h = (h * up_scale[idx]).to(dt)
            h = F.gelu(h, approximate="tanh")
            out = torch.einsum("bkf,bkfd->bkd", h, down_sel)
            if down_scale is not None:
                out = (out * down_scale[idx]).to(dt)
            y = torch.einsum("bk,bkd->bd", gate_vals[:, 0],
                             out.to(torch.float32))
            return y[:, None].to(x.dtype)

        dispatch, combine, aux = top_k_routing(logits, k, cap,
                                               priority=positions)
        self._keep(aux)
        xin = torch.einsum("btec,btd->becd", dispatch.to(dt), x.to(dt))
        h = torch.einsum("becd,edf->becf", xin, w_up.to(dt))
        if up_scale is not None:
            h = (h * up_scale[None, :, None, :]).to(dt)
        h = F.gelu(h, approximate="tanh")
        out = torch.einsum("becf,efd->becd", h, w_down.to(dt))
        if down_scale is not None:
            out = (out * down_scale[None, :, None, :]).to(dt)
        # the combine is an f32 contraction, as in the JAX package
        y = torch.einsum("btec,becd->btd", combine,
                         out.to(torch.float32))
        return y.to(x.dtype)


class ExpertParallelMoEFFN(nn.Module):
    """This rank's part of a trained (f32, unquantized) :class:`MoEFFN`
    on a mesh (``transformer.make_lm_mesh``): the router replicated, the
    stacks split as *shardings* say (``experts_up [E/e, D, F/m]``,
    ``experts_down [E/e, F/m, D]`` on the ``expert`` and ``model``
    axes); its input is this rank's tokens, split over ``(data,
    expert)`` and over *seq_axis*.  One forward:

    1. the router logits [B, T/s, E] and the positions are gathered over
       *seq_axis* (capacity slots go by position over the whole
       sequence, and under the zig-zag layout another rank's tokens may
       come first), the plan is made on the whole sequence, and this
       rank keeps its rows;
    2. the local dispatch; over *seq_axis* each slot is filled on the
       one rank holding its token, so the partial [B, E, C, D] are
       summed (a sum with zeros: exact);
    3. the all-to-all over ``expert``: each rank gets its experts' slots
       of every expert rank's rows, [e B, E/e, C, D];
    4. up, GELU, down, the down projection's partials summed over
       ``model``;
    5. the all-to-all back, and the combine of this rank's tokens.

    The aux loss's route fractions and mean probabilities are summed
    over the batch axes before their product, so it is the whole
    batch's, the same on every rank.  Sums that every rank then uses
    alike pass their gradient through unchanged
    (``collectives.reduce_from_group``): a rank's combine reads only the
    slots of its own tokens, and its aux gradient reaches only its own
    rows, so the gradients summed over the token axes afterwards count
    each token once."""

    def __init__(self, moe: MoEFFN, mesh, shardings, seq_axis):
        super().__init__()
        from . import parallel

        if moe.quantized:
            raise ValueError("expert parallelism trains f32 stacks, not "
                             "quantized ones")
        sizes = parallel.mesh_shape(mesh)
        self.n_experts, self.k = moe.n_experts, moe.k
        self.capacity_factor, self.capacity = moe.capacity_factor, \
            moe.capacity
        self.aux_weight, self.dtype = moe.aux_weight, moe.dtype
        self.keep_aux, self.aux = moe.keep_aux, None
        for name in ("router", "experts_up", "experts_down"):
            setattr(self, name, nn.Parameter(
                shardings[name].local(getattr(moe, name).detach())))

        def group(axis, split=True):
            if not split or sizes.get(axis, 1) == 1:
                return None
            return mesh.get_group(axis)

        spec = shardings["experts_up"].spec
        self.expert_group = group("expert", "expert" in spec)
        self.model_group = group("model", "model" in spec)
        self.seq_group = group(seq_axis) if seq_axis else None
        self.seq_rank = mesh.get_local_rank(seq_axis) \
            if self.seq_group is not None else 0
        self.batch_groups = [group(a) for a in ("data", "expert")
                             if group(a) is not None]
        self.batch_ranks = math.prod(sizes.get(a, 1)
                                     for a in ("data", "expert"))

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                capacity: Optional[int] = None) -> torch.Tensor:
        from . import collectives

        B, t, D = x.shape
        E, k, dt = self.n_experts, self.k, self.dtype
        logits = torch.einsum("btd,de->bte", x.to(torch.float32),
                              self.router)
        if self.seq_group is not None:
            logits = collectives.gather_from_group(logits, self.seq_group,
                                                   dim=1)
            if positions is not None:
                positions = collectives.all_gather(positions,
                                                   self.seq_group, dim=1)
        T = logits.shape[1]
        cap = capacity if capacity is not None else self.capacity
        if cap is None:
            cap = moe_capacity(T, E, k, self.capacity_factor)
        dispatch, combine, probs, gate_idx = _plan(logits, k, cap,
                                                   positions)
        stats = torch.stack([
            F.one_hot(gate_idx, E).to(torch.float32).sum(dim=(0, 1, 2)) / k,
            probs.sum(dim=(0, 1))])
        for g in self.batch_groups:
            stats = collectives.reduce_from_group(stats, g)
        n = B * T * self.batch_ranks
        if self.keep_aux:
            self.aux = self.aux_weight * E * (
                (stats[0] / n) * (stats[1] / n)).sum()
        rows = slice(self.seq_rank * t, (self.seq_rank + 1) * t)
        dispatch, combine = dispatch[:, rows], combine[:, rows]

        xin = torch.einsum("btec,btd->becd", dispatch.to(dt), x.to(dt))
        if self.seq_group is not None:
            xin = collectives.reduce_from_group(xin, self.seq_group)
        if self.expert_group is not None:
            xin = collectives.all_to_all(xin, self.expert_group,
                                         split_dim=1, cat_dim=0)
        if self.model_group is not None:
            xin = collectives.copy_to_group(xin, self.model_group)
        h = F.gelu(torch.einsum("becd,edf->becf", xin,
                                self.experts_up.to(dt)), approximate="tanh")
        out = torch.einsum("becf,efd->becd", h, self.experts_down.to(dt))
        if self.model_group is not None:
            out = collectives.reduce_from_group(out, self.model_group)
        if self.expert_group is not None:
            out = collectives.all_to_all(out, self.expert_group,
                                         split_dim=0, cat_dim=1)
        y = torch.einsum("btec,becd->btd", combine, out.to(torch.float32))
        return y.to(x.dtype)


def moe_ffn_oracle(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                   k: int, capacity: Optional[int] = None) -> torch.Tensor:
    """Per-token reference (no dense dispatch): every token through its
    top-k experts, gates renormalised, f32 throughout.  Equals
    :class:`MoEFFN` when no token exceeds capacity.  *params* holds
    ``router``, ``experts_up`` and ``experts_down`` (a module's state
    dict does)."""
    del capacity
    w_router = params["router"].to(torch.float32)
    w_up = params["experts_up"].to(torch.float32)
    w_down = params["experts_down"].to(torch.float32)
    B, T, D = x.shape
    xf = x.to(torch.float32)
    logits = torch.einsum("btd,de->bte", xf, w_router)
    _, gate_vals, gate_idx = _top_k_gates(logits, k)
    h = F.gelu(torch.einsum("btd,edf->betf", xf, w_up), approximate="tanh")
    all_out = torch.einsum("betf,efd->betd", h, w_down)   # [B, E, T, D]
    sel = torch.take_along_dim(
        all_out.movedim(1, 2),                            # [B, T, E, D]
        gate_idx[..., None].expand(B, T, k, D), dim=2)    # [B, T, k, D]
    return torch.einsum("btk,btkd->btd", gate_vals, sel)
