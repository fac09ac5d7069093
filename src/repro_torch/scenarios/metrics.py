"""Per-round metric streams of the scenario engine, on the state's device.

Counterpart of ``repro.scenarios.metrics``.  The Simulator computes these
after every scheduled round and keeps each value as a 0-d tensor on the
device; a chunk of rounds is stacked and copied to the host once, at the
next evaluation point, as the reference's scan emits its ys:

  * ``consensus``       sum over active nodes of ||x_i - x̄_active||²;
  * ``tracking_err``    sum over active nodes of ||b_i - g*||² of the
                        algorithm's declared ``tracking_buffer`` (v for the
                        DSE family, y for gradient tracking; NaN where none
                        is declared), g* = ∇f(x̄) in the Simulator, else the
                        active mean of the buffer;
  * ``spectral_gap``    max |eig| of diag(a) W_t diag(a) - a aᵀ/|a|, the
                        active block's λ_t (``torch.linalg.eigvalsh`` in
                        fp32, as the reference calls ``jnp.linalg.eigvalsh``
                        outside any kernel); it depends on (W_t, a) alone, so
                        the Simulator computes a chunk's gaps in one batched
                        call;
  * ``active_nodes``    |a|;
  * ``compression_err`` sum of the error-feedback residuals' ||e||² (NaN
                        without residuals);
  * ``replica_drift``   sum of ||b - x̂||² between each gossiped buffer and
                        its channel replica (NaN without replicas);
  * ``staleness``       mean snapshot age over async wire buffers (NaN
                        otherwise);
  * ``send_rate``       share of (node, buffer) sites whose async trigger
                        fired this round (NaN otherwise).

``STREAM_FIELDS`` is the telemetry registry's ``TRAINING_STREAM_FIELDS``
(``repro_torch.telemetry.registry``), re-exported as the reference does.

With a ``mesh`` (the sharded engine's :class:`~repro_torch.launch.mesh.
NodeMesh`) the state and the round context hold this rank's rows, and every
sum over nodes is completed by ``mesh.all_reduce_sum``: the active mean
x̄, the squared distances, the residuals, the ages and send masks.  The
spectral gap takes all of W_t and the active mask, gathered by
``mesh.full``.  On a model axis (``shard_dims``: each parameter leaf's
model-sharded dim, or None), and under '2d' also over the data ranks
(``data_dims``: its data-sharded dim), a rank holds shards: the sums over
a node's leaves add the shards over the node's ranks (``mesh.node_group``:
the model group in rank order, then the data group), each distinct block
once -- a leaf replicated over a group from that group's index 0 -- as the
engine's ``v_norm`` does, before the sum over nodes.  Every rank gets the
same values.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..compression.base import _wire_entries, compression_error
from ..telemetry.registry import TRAINING_STREAM_FIELDS
from ..tree import tree_leaves, tree_map

Tree = Any

__all__ = [
    "STREAM_FIELDS",
    "masked_consensus",
    "tracking_buffer",
    "tracking_error",
    "effective_spectral_gap",
    "replica_drift",
    "staleness",
    "send_rate",
    "make_stream_fn",
]

#: re-exported from the registry, the one place stream names are declared
STREAM_FIELDS = TRAINING_STREAM_FIELDS


def _nan(device) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=torch.float32, device=device)


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A sum over this rank's nodes completed over every rank's."""
    return x if mesh is None else mesh.all_reduce_sum(x)


def _leaves(values, dims, mesh, data_dims=None):
    """Σ of per-leaf values (0-d tensors, in the order ``dims`` and
    ``data_dims`` list the leaves) over a whole node: this rank's values, on
    a node of several ranks summed over them with each distinct block
    counted once."""
    node = None if mesh is None else mesh.node_group
    if node is None or (dims is None and data_dims is None):
        return sum(values)
    model, data = mesh.model_group, mesh.data_group
    dims = [None] * len(values) if dims is None else dims
    data_dims = [None] * len(values) if data_dims is None else data_dims
    total = sum(v for v, d, dd in zip(values, dims, data_dims)
                if (d is not None or model is None or model.index == 0)
                and (dd is not None or data is None or data.index == 0))
    if not torch.is_tensor(total):
        total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    return node.all_reduce(total)


def _weights(n: int, active: Optional[torch.Tensor], device, mesh=None):
    """(a, k): the fp32 active mask of these rows and max(|a|, 1) over all."""
    a = (torch.ones(n, dtype=torch.float32, device=device) if active is None
         else active.float())
    return a, torch.clamp(_sum(a.sum(), mesh), min=1.0)


def masked_consensus(tree: Tree, active: Optional[torch.Tensor], mesh=None,
                     shard_dims=None, data_dims=None) -> torch.Tensor:
    """Σ_{i active} ||x_i - x̄_active||² over the whole tree."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    a, k = _weights(n, active, leaves[0].device, mesh)

    def one(x):
        xf = x.float().reshape(n, -1)
        mean = _sum(a @ xf, mesh) / k
        d = (xf - mean[None]) * a[:, None]
        return torch.sum(d * d)

    return _sum(_leaves([one(x) for x in leaves], shard_dims, mesh, data_dims), mesh)


def tracking_buffer(state, name: Optional[str]) -> Optional[Tree]:
    """The algorithm's declared gradient-direction buffer, if any."""
    if name is None:
        return None
    return getattr(state, name, None)


def tracking_error(
    state,
    active: Optional[torch.Tensor],
    grad_at_mean: Optional[Callable[[Tree], Tree]] = None,
    buffer_name: Optional[str] = None,
    mesh=None,
    shard_dims=None,
    data_dims=None,
) -> torch.Tensor:
    """Σ_{i active} ||b_i − g*||² of the declared buffer (NaN when the
    algorithm declares none).  ``grad_at_mean`` maps the node-mean params
    x̄ to ∇f(x̄) (the Simulator's; not with a mesh); without it the buffer's
    active mean is the reference."""
    buf = tracking_buffer(state, buffer_name)
    if buf is None:
        return _nan(tree_leaves(state.params)[0].device)
    if grad_at_mean is not None and mesh is not None:
        raise ValueError("tracking_error takes grad_at_mean or a mesh, not both")
    leaves = tree_leaves(buf)
    n = leaves[0].shape[0]
    a, k = _weights(n, active, leaves[0].device, mesh)
    if grad_at_mean is not None:
        xbar = tree_map(lambda p: p.float().mean(dim=0), state.params)
        ref = [r.float().reshape(-1) for r in tree_leaves(grad_at_mean(xbar))]
    else:
        ref = [_sum(a @ x.float().reshape(n, -1), mesh) / k for x in leaves]
    parts = []
    for x, r in zip(leaves, ref):
        d = (x.float().reshape(n, -1) - r[None]) * a[:, None]
        parts.append(torch.sum(d * d))
    return _sum(_leaves(parts, shard_dims, mesh, data_dims), mesh)


def effective_spectral_gap(w: torch.Tensor, active: Optional[torch.Tensor]) -> torch.Tensor:
    """λ_t = max |eig|(diag(a) W diag(a) − a aᵀ/|a|) in fp32.

    ``w`` is (..., N, N) and ``active`` (..., N) or None: leading dimensions
    batch the rounds into one ``eigvalsh`` call.  W is symmetric, so the
    eigenvalues give the spectral norm exactly; masked rows and columns add
    zero eigenvalues, which never exceed a connected active block's gap."""
    w = w.float()
    a = (torch.ones(w.shape[:-1], dtype=torch.float32, device=w.device) if active is None
         else active.float())
    k = torch.clamp(a.sum(dim=-1), min=1.0)
    outer = a[..., :, None] * a[..., None, :]
    m = w * a[..., :, None] * a[..., None, :] - outer / k[..., None, None]
    return torch.linalg.eigvalsh(m).abs().amax(dim=-1)


def replica_drift(state, comm_buffers: Optional[Sequence[str]] = None,
                  mesh=None, shard_dims=None, data_dims=None) -> torch.Tensor:
    """Σ ||b − x̂||² between each gossiped buffer and its channel replica
    (the ``"hat"`` wire entries, matched to ``comm_buffers`` by position);
    NaN for channels without replicas.  A replicated wire's replica is
    taken at this rank's rows."""
    comp = getattr(state, "comp", None)
    if comp is None or comm_buffers is None:
        return _nan(tree_leaves(state.params)[0].device)
    parts, dims, ddims = [], [], []
    for name, wire in zip(comm_buffers, comp.wire):
        if not isinstance(wire, dict) or wire.get("hat") is None:
            continue
        buf = getattr(state, name, None)
        if buf is None:
            continue
        hat = wire["hat"] if mesh is None else mesh.rows(wire["hat"])
        for b, h in zip(tree_leaves(buf), tree_leaves(hat)):
            d = b.float() - h.float()
            parts.append(torch.sum(d * d))
        dims += list(shard_dims) if shard_dims is not None else []
        ddims += list(data_dims) if data_dims is not None else []
    if not parts:
        return _nan(tree_leaves(state.params)[0].device)
    return _sum(_leaves(parts, dims if shard_dims is not None else None, mesh,
                        ddims if data_dims is not None else None), mesh)


def _node_mean(v: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a per-node vector over all N nodes; a replicated wire's
    vector holds them all already."""
    if mesh is None or v.shape[0] == mesh.n_nodes:
        return v.float().mean()
    return mesh.all_reduce_sum(v.float().sum()) / mesh.n_nodes


def staleness(state, mesh=None) -> torch.Tensor:
    """Mean per-node snapshot age over async wire buffers (NaN otherwise)."""
    ages = _wire_entries(state, "age")
    if not ages:
        return _nan(tree_leaves(state.params)[0].device)
    return sum(_node_mean(a, mesh) for a in ages) / len(ages)


def send_rate(state, mesh=None) -> torch.Tensor:
    """Share of (node, buffer) sites that sent this round (NaN when no
    async wire state is attached)."""
    sent = _wire_entries(state, "sent")
    if not sent:
        return _nan(tree_leaves(state.params)[0].device)
    return sum(_node_mean(s, mesh) for s in sent) / len(sent)


def make_stream_fn(
    grad_at_mean: Optional[Callable[[Tree], Tree]] = None,
    buffer_name: Optional[str] = None,
    comm_buffers: Optional[Sequence[str]] = None,
    spectral_gap: bool = True,
    mesh=None,
    shard_dims=None,
    data_dims=None,
):
    """The per-round stream function ``(state, ctx) -> dict`` of 0-d fp32
    tensors, one per :data:`STREAM_FIELDS` entry.

    ``spectral_gap=False`` leaves that field out, for callers that compute
    it for a whole chunk of rounds in one batched call.  With a ``mesh`` the
    state and ``ctx`` hold this rank's rows, and with ``shard_dims`` (and
    under '2d' ``data_dims``) its shards (module docstring)."""

    def stream(state, ctx) -> dict:
        active = ctx.active
        leaf = tree_leaves(state.params)[0]
        n, dev = leaf.shape[0], leaf.device
        out = {
            "consensus": masked_consensus(state.params, active, mesh, shard_dims, data_dims),
            "tracking_err": tracking_error(state, active, grad_at_mean, buffer_name, mesh,
                                           shard_dims, data_dims),
        }
        if spectral_gap:
            if ctx.w is None:
                out["spectral_gap"] = _nan(dev)
            elif mesh is None:
                out["spectral_gap"] = effective_spectral_gap(ctx.w, active)
            else:
                # all of W_t and of the mask, gathered where other ranks
                # hold rows of them
                full = mesh.full if mesh.world > 1 else (lambda t: t)
                out["spectral_gap"] = effective_spectral_gap(
                    full(ctx.w), None if active is None else full(active))
        out["active_nodes"] = (_sum(active.float().sum(), mesh) if active is not None
                               else torch.tensor(float(n if mesh is None else mesh.n_nodes),
                                                 device=dev))
        residuals = _wire_entries(state, "res")
        if residuals and (shard_dims is not None or data_dims is not None):
            residual = _leaves([torch.sum(leaf.float() ** 2) for tree in residuals
                                for leaf in tree_leaves(tree)],
                               None if shard_dims is None else list(shard_dims) * len(residuals),
                               mesh,
                               None if data_dims is None else list(data_dims) * len(residuals))
        else:
            residual = compression_error(state)
        out["compression_err"] = _sum(residual, mesh) if residuals else residual
        out["replica_drift"] = replica_drift(state, comm_buffers, mesh, shard_dims, data_dims)
        out["staleness"] = staleness(state, mesh)
        out["send_rate"] = send_rate(state, mesh)
        return out

    return stream
