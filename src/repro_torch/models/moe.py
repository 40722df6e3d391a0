"""Mixture-of-Experts FFN: sort-based (MegaBlocks-style) dispatch.

Counterpart of ``repro.models.moe``.  Tokens are split into
``cfg.moe_groups`` groups (``_n_groups``); within a group the (token,
choice) assignments are sorted by expert id with a STABLE sort, each
expert keeps its first ``C`` (``_capacity``) and the later ones overflow
to a dump row, and the kept tokens are gathered into an (E, C, d)
buffer.  The groups run side by side on a leading G axis, where the
reference ``vmap``s ``_dispatch_group``/``_combine_group``; those two
keep the reference's one-group signatures.  The expert products
``gecd,edf->gecf`` are ``torch.einsum``s, as the reference's are XLA
(no Pallas kernel).  Shared experts (qwen2-moe: 4 merged into one wide
SwiGLU; llama4: 1) are a dense FFN added to the routed output.

Routing matches ``jax.lax.top_k``: the K largest router probabilities,
ties to the lower expert id (a stable descending sort; ``torch.topk``
promises no order on ties).

Two sums add K rows into each token's row: the combine (the reference's
``.at[ts].add``) and the backward of the dispatch gather ``x[ts]``.
Neither is a scatter here: each token's K assignments are gathered in
the stable sort's order (ascending expert id, the order in which the
reference's scatter receives them) and added left to right in the
compute dtype, rounding after each add as the reference does.  The two
``autograd.Function``s below are each other's backward, so the sums are
the same on every run and on every device.  The reference's ``_shard``
constraints have no counterpart: one device has no mesh.

The expert-parallel layer of the ``hybrid_moe`` family
(``held_moe_apply``, GraniteMoeHybrid's) has no counterpart in the
reference.  It routes every token over all ``n_experts`` and computes
only the part of the result that the experts this device holds give
(``held_range``): the share of one rank of expert parallelism, run
without its exchange.  It is dropless: every assignment to a held expert
is computed, in one grouped product a weight over the assignments sorted
by expert (``grouped_mm``), with no host sync.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.config import ArchConfig
from repro_torch.obs.profiling import scope


def moe_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    """The reference's MoE params (``router``, ``w_gate``/``w_up`` (E, d,
    f), ``w_down`` (E, f, d), ``shared``) at its scales; ``lead`` =
    (n_layers,) stacks them."""
    lead = tuple(lead)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": cm.dense_init(generator, d, E, scale=0.02, lead=lead,
                                device=device),
        "w_gate": cm.dense_init(generator, d, f, lead=lead + (E,),
                                device=device),
        "w_up": cm.dense_init(generator, d, f, lead=lead + (E,),
                              device=device),
        "w_down": cm.dense_init(generator, f, d, lead=lead + (E,),
                                device=device),
    }
    if cfg.shared_d_ff:
        s = cfg.shared_d_ff
        p["shared"] = {
            "w_gate": cm.dense_init(generator, d, s, lead=lead,
                                    device=device),
            "w_up": cm.dense_init(generator, d, s, lead=lead, device=device),
            "w_down": cm.dense_init(generator, s, d, lead=lead,
                                    device=device),
        }
    return p


def _capacity(cfg: ArchConfig, n_assign: int) -> int:
    c = int(n_assign * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _n_groups(cfg: ArchConfig, T: int) -> int:
    g = min(cfg.moe_groups, T)
    while T % g != 0:
        g -= 1
    return max(g, 1)


# ---------------------------------------------------------------------------
# Fixed-order sums of each token's K rows
# ---------------------------------------------------------------------------

def _ordered_sum(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(T, d): row t is ``rows[pos[t, 0]] + rows[pos[t, 1]] + ...``,
    added left to right in ``rows``' dtype."""
    out = rows[pos[:, 0]]
    for k in range(1, pos.shape[1]):
        out = out + rows[pos[:, k]]
    return out


class _TokenGather(torch.autograd.Function):
    """``x[tok]`` (each token K times); its backward adds each token's K
    gradient rows in the fixed order ``pos``."""

    @staticmethod
    def forward(ctx, x, tok, pos):
        ctx.save_for_backward(pos)
        return x[tok]

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return _ordered_sum(g, pos), None, None


class _TokenSum(torch.autograd.Function):
    """Each token's K rows of ``rows`` added in the fixed order ``pos``;
    its backward gathers the token's gradient back to its K rows."""

    @staticmethod
    def forward(ctx, rows, tok, pos):
        ctx.save_for_backward(tok)
        return _ordered_sum(rows, pos)

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        return g[tok], None, None


def _token_positions(ts: torch.Tensor, K: int) -> torch.Tensor:
    """(G, Tg, K): the sorted positions of each token's K assignments, in
    ascending order (``ts``: (G, n) tokens in sorted order)."""
    G, n = ts.shape
    return torch.argsort(ts, dim=1, stable=True).reshape(G, n // K, K)


def _flat(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """(G, ...) per-group indices as indices into the G groups laid end
    to end, ``stride`` apart."""
    g = torch.arange(idx.shape[0], device=idx.device)
    return (idx + (g * stride).view((-1,) + (1,) * (idx.dim() - 1))
            ).reshape(-1)


# ---------------------------------------------------------------------------
# Dispatch and combine
# ---------------------------------------------------------------------------

def _route(cfg: ArchConfig, eids: torch.Tensor, gates: torch.Tensor,
           C: int):
    """(ts, slot, keep, gs) of G groups at once; eids/gates (G, Tg, K).
    The integers are the reference's ``_dispatch_group``'s: a stable sort
    of the flat expert ids, each expert's rank among its assignments,
    and ranks past ``C`` sent to the dump slot E*C."""
    G, Tg, K = eids.shape
    E = cfg.n_experts
    n = Tg * K
    e_flat = eids.reshape(G, n).to(torch.int64)
    perm = torch.argsort(e_flat, dim=1, stable=True)
    es = torch.gather(e_flat, 1, perm)
    ts = perm // K                        # t_flat = repeat(arange(Tg), K)
    gs = torch.gather(gates.reshape(G, n), 1, perm)
    experts = torch.arange(E, device=eids.device).expand(G, E).contiguous()
    offsets = torch.searchsorted(es, experts)                  # (G, E)
    rank = torch.arange(n, device=eids.device) - torch.gather(offsets, 1, es)
    keep = rank < C
    slot = torch.where(keep, es * C + rank, torch.full_like(es, E * C))
    return ts, slot, keep, gs


def _dispatch_group(cfg: ArchConfig, x, eids, gates, C: int):
    """Sort-based dispatch for ONE group.  x (Tg, d); eids/gates (Tg, K).
    Returns (xe (E, C, d), ts, slot, keep, gs) for the combine."""
    xe, ts, slot, keep, gs = _dispatch_groups(cfg, x[None], eids[None],
                                              gates[None], C)
    return xe[0], ts[0], slot[0], keep[0], gs[0]


def _dispatch_groups(cfg: ArchConfig, x, eids, gates, C: int):
    """``_dispatch_group`` over a leading G axis: x (G, Tg, d), eids and
    gates (G, Tg, K); returns xe (G, E, C, d) and (G, Tg*K) integers."""
    G, Tg, d = x.shape
    E, K = cfg.n_experts, eids.shape[-1]
    ts, slot, keep, gs = _route(cfg, eids, gates, C)
    pos = _token_positions(ts, K)
    rows = _TokenGather.apply(x.reshape(G * Tg, d), _flat(ts, Tg),
                              _flat(pos, Tg * K).view(G * Tg, K))
    xbuf = torch.zeros((G * (E * C + 1), d), dtype=x.dtype, device=x.device)
    # kept slots are distinct; only the dump rows, cut off below, collide
    xbuf = xbuf.index_put((_flat(slot, E * C + 1),), rows)
    xe = xbuf.view(G, E * C + 1, d)[:, :E * C].reshape(G, E, C, d)
    return xe, ts, slot, keep, gs


def _combine_group(cfg: ArchConfig, ye, ts, slot, keep, gs, Tg: int):
    """ONE group's combine: ye (E, C, d) -> (Tg, d)."""
    return _combine_groups(cfg, ye[None], ts[None], slot[None], keep[None],
                           gs[None], Tg)[0]


def _combine_groups(cfg: ArchConfig, ye, ts, slot, keep, gs, Tg: int):
    """``_combine_group`` over a leading G axis: ye (G, E, C, d) -> (G,
    Tg, d).  A dropped assignment reads the zero row past the experts'
    (the reference's ``where(keep, …, 0)``)."""
    G, E, C, d = ye.shape
    K = ts.shape[1] // Tg
    dt = ye.dtype
    y_rows = torch.cat([ye.reshape(G, E * C, d),
                        torch.zeros((G, 1, d), dtype=dt, device=ye.device)],
                       dim=1)
    contrib = y_rows.reshape(G * (E * C + 1), d)[_flat(slot, E * C + 1)]
    contrib = contrib * gs.reshape(-1, 1).to(dt)
    pos = _token_positions(ts, K)
    y = _TokenSum.apply(contrib, _flat(ts, Tg),
                        _flat(pos, Tg * K).view(G * Tg, K))
    return y.view(G, Tg, d)


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def route_probs(cfg: ArchConfig, p, x: torch.Tensor):
    """(probs (T, E) f32, gates (T, K), eids (T, K) int32): the router's
    softmax and its top K, ties to the lower expert id as in
    ``jax.lax.top_k``, the gates renormalised to sum to one."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = vals[:, :cfg.top_k], idx[:, :cfg.top_k].to(torch.int32)
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    return probs, gates, eids


def moe_apply(cfg: ArchConfig, p, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens.  Returns (y (T, d), aux_loss ()): the grouped
    dispatch, the experts' SwiGLU, the combine, plus the shared FFN, and
    the Switch-style load-balance loss over all T tokens."""
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype

    probs, gates, eids = route_probs(cfg, p, x)
    me = torch.mean(probs, dim=0)
    # the one-hot of each token's first choice, without one_hot's range
    # check (a host sync on a card)
    first = eids[:, :1] == torch.arange(E, device=x.device)
    ce = torch.mean(first.to(torch.float32), dim=0)
    aux = torch.sum(me * ce) * E

    G = _n_groups(cfg, T)
    Tg = T // G
    C = _capacity(cfg, Tg * K)
    xe, ts, slot, keep, gs = _dispatch_groups(
        cfg, x.reshape(G, Tg, d), eids.reshape(G, Tg, K),
        gates.reshape(G, Tg, K), C)
    h = _act(cfg, torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt))
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    y = _combine_groups(cfg, ye, ts, slot, keep, gs, Tg).reshape(T, d)

    if cfg.shared_d_ff:
        sp = p["shared"]
        hs = _act(cfg, x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))
        y = y + hs @ sp["w_down"].to(dt)
    return y, aux



# ---------------------------------------------------------------------------
# Expert parallelism, dropless (hybrid_moe)
# ---------------------------------------------------------------------------

def held_range(cfg: ArchConfig) -> Tuple[int, int]:
    """``(first, count)``: this device holds experts first .. first +
    count - 1 of ``cfg.n_experts`` (all of them when ``experts_held`` is
    0)."""
    held = cfg.experts_held or cfg.n_experts
    first = cfg.expert_rank * held
    if first < 0 or first + held > cfg.n_experts:
        raise ValueError(f"expert share {cfg.expert_rank} of {held} does "
                         f"not fit {cfg.n_experts} experts")
    return first, held


def held_moe_init(generator, cfg: ArchConfig, *, lead=(), device="cuda"):
    """The router over all experts (…, d, n_experts), the held experts'
    ``w_gate``/``w_up`` (…, held, d, f) and ``w_down`` (…, held, f, d),
    and the shared SwiGLU ``shared`` (d_ff ``shared_d_ff``); ``lead`` =
    (n_layers,) stacks them."""
    lead = tuple(lead)
    d, f = cfg.d_model, cfg.d_ff
    held = held_range(cfg)[1]

    def dense(d_in, d_out, more=()):
        return cm.dense_init(generator, d_in, d_out, lead=lead + more,
                             device=device)

    p = {"router": dense(d, cfg.n_experts),
         "w_gate": dense(d, f, (held,)), "w_up": dense(d, f, (held,)),
         "w_down": dense(f, d, (held,))}
    s = cfg.shared_d_ff
    p["shared"] = {"w_gate": dense(d, s), "w_up": dense(d, s),
                   "w_down": dense(s, d)}
    return p


_EXPERT_ROWS: Dict[torch.device, torch.Tensor] = {}


def expert_rows(device) -> torch.Tensor:
    """The count, on ``device``, of the assignments that held experts
    have computed in this process: each call of ``held_moe_apply`` adds
    its own, the forward and remat's recompute alike (a device add, no
    host sync).  Read it after a run."""
    key = torch.device(device)
    if key not in _EXPERT_ROWS:
        _EXPERT_ROWS[key] = torch.zeros((), dtype=torch.int64, device=key)
    return _EXPERT_ROWS[key]


def _grouped_plain(x: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """``grouped_mm`` by one masked product a group (every row times
    every group's weight): the plain version, rows past the last group
    zero."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    start = torch.cat([offs.new_zeros(1), offs[:-1]])
    y = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype,
                    device=x.device)
    for e in range(w.shape[0]):
        inside = (rows >= start[e]) & (rows < offs[e])
        y = y + torch.where(inside, x @ w[e], 0.0)
    return y


class _GroupedMM(torch.autograd.Function):
    """``torch._grouped_mm`` forward and backward: dx by the same grouped
    product against wᵀ, dw by the product grouped along the rows, which
    reads no row past the last group."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return torch._grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, g):
        x, w, offs = ctx.saved_tensors
        g = g.contiguous()
        dx = torch._grouped_mm(g, w.transpose(-2, -1), offs=offs)
        dw = torch._grouped_mm(x.transpose(0, 1), g, offs=offs)
        return dx, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """x (N, d_in), w (E, d_in, d_out), offs (E,) int32 group ends:
    rows offs[e-1] .. offs[e]-1 of x times w[e].  Rows past ``offs[-1]``
    are left undefined (the callers read none of them), and so are their
    gradients.  bf16 CUDA tensors take ``torch._grouped_mm``; any other
    takes the plain version."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return _GroupedMM.apply(x, w, offs)
    return _grouped_plain(x, w, offs)


class _HeldGather(torch.autograd.Function):
    """x[tok]: each token's row once for each of its K assignments, in
    sorted order; its backward sums each token's rows of the held
    assignments (positions ``pos`` (T, K), masked by ``held``) in a
    fixed order, reading no other row."""

    @staticmethod
    def forward(ctx, x, tok, pos, held):
        ctx.save_for_backward(pos, held)
        return x[tok]

    @staticmethod
    def backward(ctx, g):
        pos, held = ctx.saved_tensors
        rows = g[pos.reshape(-1)].view(pos.shape + g.shape[-1:])
        return (torch.where(held[..., None], rows, 0.0).sum(1), None, None,
                None)


class _Permute(torch.autograd.Function):
    """rows[perm] for a permutation ``perm`` of the rows, whose inverse
    is ``inv``: the backward is the gather g[inv], with no scatter."""

    @staticmethod
    def forward(ctx, rows, perm, inv):
        ctx.save_for_backward(inv)
        return rows[perm]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g[inv], None, None


def held_route(cfg: ArchConfig, p, x: torch.Tensor):
    """(gates (T, K) f32, eids (T, K) int64): the K largest router logits
    over all experts, ties to the lower expert id, and the gates a
    softmax over those K logits (GraniteMoeHybrid's router)."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    K = cfg.top_k
    return torch.softmax(vals[:, :K], dim=-1), idx[:, :K]


def held_moe_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) -> the held experts' part of the routed output plus
    the shared expert's, in the span ``obs.moe`` (the grouped products
    in ``obs.experts``).

    The T·K assignments are sorted by expert with the held ones first (a
    stable sort: each expert's rows in token order) and every token's
    row is gathered once for each of its assignments; the grouped
    products stop at the held count, a device value (``offs[-1]``), and
    the rows past it are never read.  Each assignment keeps its own row
    in that order, so the combine gathers a permutation and its backward
    is a gather too."""
    with scope("obs.moe"):
        b, s, d = x.shape
        x = x.reshape(b * s, d)
        T, K, dt = b * s, cfg.top_k, x.dtype
        first, held = held_range(cfg)
        gates, eids = held_route(cfg, p, x)
        local = eids - first
        is_held = (local >= 0) & (local < held)                 # (T, K)
        key = torch.where(is_held, local, held).reshape(-1)
        order = torch.argsort(key, stable=True)
        offs = torch.searchsorted(
            key[order], torch.arange(1, held + 1, device=x.device)
        ).to(torch.int32)
        pos = torch.empty_like(order)
        pos[order] = torch.arange(T * K, device=x.device)
        xs = _HeldGather.apply(x, order // K, pos.view(T, K), is_held)
        wg, wu, wd = (p[k].to(dt) for k in ("w_gate", "w_up", "w_down"))
        with scope("obs.experts"):
            a, u = grouped_mm(xs, wg, offs), grouped_mm(xs, wu, offs)
        h = _act(cfg, a) * u
        with scope("obs.experts"):
            ys = grouped_mm(h, wd, offs)
        with torch.no_grad():
            expert_rows(x.device).add_(offs[-1])
        # the rows of assignments to other experts are undefined: masked
        # before the gates multiply them, so no gradient reads them
        contrib = torch.where(is_held[..., None],
                              _Permute.apply(ys, pos, order).view(T, K, d),
                              0.0)
        y = (contrib * gates.to(dt)[..., None]).sum(1)
        sp = p["shared"]
        hs = _act(cfg, x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))
        y = y + hs @ sp["w_down"].to(dt)
        return y.view(b, s, d)
