"""The sharded decentralized training job: N nodes over a node mesh.

Counterpart of the training half of ``repro.launch.distributed``.

  * decentralized nodes = the rows of every state tensor's leading node
    axis; rank r of the :class:`~repro_torch.launch.mesh.NodeMesh` holds
    the contiguous block ``[lo, hi)`` (world 1 holds all N on one device,
    as the Simulator does);
  * per-node model compute = a loop over this rank's nodes: each node's
    parameter slice is detached, made a leaf, and differentiated with
    ``torch.autograd.grad`` of its own ``Model.loss`` (bf16 activations).
    The reference vmaps ``grad``; the kernel ops are autograd Functions
    with CUDA bodies, which ``torch.func.vmap`` cannot carry;
  * one ``step_fn`` call = one communication round, built by the executor
    the Simulator uses (``core.algorithm.make_round_step``): ``round_len -
    1`` local updates, then the algorithm's ``comm_update``, for every
    entry of ``core.ALGORITHMS``;
  * gossip backends: 'dense' (this rank's rows of W times the all-gathered
    stack) and 'roll' (only ring neighbours move, by send / recv), and for
    the gossip channels the packed transports of ``compression.gossip``
    selected by ``wire_mode``, branch for branch as the reference selects
    them.

Within-node layouts: a mesh with a model axis (``NodeMesh(model=M)``)
spreads every node over M ranks, as the job's sharding profile
(``launch/sharding.py``; by default the arch's) lays it out.  Each state
leaf's layout is its parameter's logical axes resolved under the profile's
``train_param_rules`` (``TrainJob.state_layout``); a rank holds its shard of
every node-stacked buffer, the update arithmetic runs on the shards as it
is (it is elementwise), and gossip mixes each shard with the same model
index on the other nodes (mixing is linear).  Per node:

  * 'fsdp' -- the rank all-gathers the whole parameter tree over the model
    group before the node's forward, differentiates its share of the node
    batch and reduce-scatters the gradients' sum, divided by M.  Where the
    node batch does not divide by M (or holds a mask, or the model has MoE
    blocks, whose router losses are not means over tokens) every model rank
    computes the whole node batch and keeps its part of the gradient;
  * 'tp'   -- ``Model.loss(..., tp=group)``: the rank's heads, hidden units,
    experts, SSM heads and vocabulary shard (Megatron; every block kind and
    the audio encoder), every model rank on the whole node batch;
  * '2d'   -- on a ``NodeMesh(data=D, model=M)`` (the reference's pod x data
    x model mesh; nodes across ``pod`` only, so a mesh of one pod is one
    node of D x M ranks): a leaf shards ``experts`` and ``embed`` over the
    D data ranks and the features over the M model ranks (its
    ``data_dims`` and ``shard_dims``).  Per node the rank all-gathers the
    data-sharded dims over the data group (``mesh.data_group``), which
    leaves each leaf as 'tp' lays it out (the experts whole, their hidden
    units over ``model``), runs ``Model.loss(..., tp=model group,
    data=data group)`` on its data rank's rows of each microbatch of the
    node batch -- the rank's share of the whole batch's loss, a MoE
    queueing the whole batch and its router losses the whole batch's
    (``models/mlp.py``) -- and reduce-scatters the gradients' sum over the
    data group onto each data-sharded dim (all-reduces the rest): the
    gradient of the whole node batch's loss.  Where a microbatch does not
    split over D (or holds a mask) every data rank computes all of it and
    keeps its part of the gradient.

On a model axis of 1 every profile is the node-a-replica job bit for bit.
On a node of several ranks -- a model axis, or under '2d' D data x M
model ranks -- every codec, channel, wire mode and scenario runs as at
model 1 and computes the function the reference's GSPMD job computes: a
node's message is a function of the whole node, never of a shard.  Each
codec is bound to each leaf's shard (``compression.base.AtShard``; under
'2d' a shard of one group, or of both with the model group's dim and the
data group's, ``Shard(mesh.node_group, dim, whole, data_dim=...)``), so
that every rank of a node encodes the same scale, index set and send
decision and decodes its shard of the whole leaf's message, bit for bit
(low-rank up to its partial sums' order); a leaf replicated over a group
is encoded alike on its ranks.  Over the node axis a rank moves its share
of a node's payload (``compression/gossip.py`` gives the byte count); the
scenario streams and the async trigger sum the shards over the node's
ranks (``mesh.node_group``: the model group, then the data group), each
distinct block once.  'tp' and 'fsdp' lay
a node over model ranks only, so a mesh with a data axis larger than 1
takes '2d' alone; a '2d' job on a model axis needs a mesh made with its
data axis (``NodeMesh(data=D)``) wherever its node axis has more than one
rank.  All of it runs on gloo ranks; NCCL across cards, and with it the
memory win of a node over several cards, is ROADMAP queue 1 item 8 (b).

The reference's serving half (``ServeJob``, ``make_serve_job``: one device
or a data x model mesh) is ``launch/serve.py``.  Decisions, not carried
over: the jobs' ``lower``, ``lower_prefill`` and ``lower_decode``
(``jax.jit(...).lower``, an XLA compile artefact, whose callers are the
reference's ``launch/dryrun.py``, not carried over, and its transport
benchmark, whose port reads counted bytes); the sequence-sharded
long-context decode cache (``lower_decode(seq_shard_cache=True)``, which
only ``dryrun.py`` asks for: ``cache_specs`` keeps the parameter and the
serve job never passes it); and a serve job for HuBERT X-Large, an encoder
with no decode path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..compression.base import (
    AtShard, ChannelState, Packed, Shard, abstract_channel_state, attach_channel_state,
)
from ..compression.channels import ChocoChannel, SeedFn, SyncChannel
from ..compression.gossip import allgather_combine, neighbor_exchange, rotation_combine
from ..core import make_algorithm, ring
from ..core.algorithm import DecentralizedAlgorithm, RoundCtx, make_round_step
from ..core.mixing import (
    Rotation, dense_mix, identity_mix, node_pin, replicate_gather, replicate_pin,
    replicated_local, roll_mix, scheduled_dense_mix, scheduled_rotation_mix,
)
from ..core.simulate import default_comm_seed_fn
from ..models import Model, ModelConfig
from ..models.common import axis_rules, resolve_specs
from ..tree import map_tensors, tree_flatten, tree_leaves, tree_unflatten
from .mesh import NodeMesh
from .sharding import PROFILES, ShardingProfile, profile_for_arch, shard_leaf

Tree = Any

__all__ = ["TrainJob", "make_train_job", "state_bytes"]


def state_bytes(state: Any) -> int:
    """Bytes of every tensor of a (real or abstract) state."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()

    map_tensors(add, state)
    return total


@dataclasses.dataclass
class TrainJob:
    """One sharded decentralized training round.

    ``step_fn(state, batches[, ctx]) -> (state, metrics)``: ``batches`` is a
    dict of tensors ``(round_len, n_local, b, ...)`` holding this rank's
    nodes (:meth:`local_batch`), ``ctx`` (with a scenario) this rank's
    :meth:`round_ctx`.  ``metrics["loss"]`` is the comm step's mean loss
    over all N nodes and ``metrics["v_norm"]`` the direction buffer's
    squared norm summed over all of them; with a scenario the stream
    values join them.  A difference channel's replica trees advance in
    place (``ChocoChannel.in_place``, the counterpart of the reference's
    buffer donation): ``step_fn`` gives up the wire of the state it is
    given, so a caller keeps the state it returns, not the one it passed.
    ``abstract_state`` is the state as meta tensors
    (this rank's rows and shards), ``state_layout`` each of its tensors'
    layout: ``"node"`` (this rank's rows), ``"replicated"`` (all N rows, the
    compressed allgather's wire) or ``"host"`` (a host int); on a model
    axis a node-stacked tensor's layout is its spec instead, ``(node axes,
    *mesh axis or None a dim)`` (the reference's ``state_shardings``).
    ``shard_dims`` gives each parameter leaf's model-sharded dim (None:
    replicated; all None on a model axis of 1) and ``data_dims`` its
    data-sharded dim under '2d' (all None without a data group)."""

    model: Model
    mesh: NodeMesh
    algorithm: Any
    tau: int                          # the algorithm's local-update interval
    round_len: int                    # batches consumed per step_fn call
    n_nodes: int
    gossip: str
    step_fn: Callable
    abstract_state: Any
    state_layout: Any
    profile: ShardingProfile
    shard_dims: Any
    data_dims: Any
    scenario: Any = None

    # ---- scenario plumbing ------------------------------------------------
    def schedule_for(self, n_rounds: int):
        """Materialize the scenario's per-round arrays for a driver loop."""
        if self.scenario is None:
            raise ValueError("job has no scenario")
        return self.scenario.materialize(self.n_nodes, n_rounds, self.round_len)

    def round_ctx(self, schedule, r: int) -> RoundCtx:
        """Round ``r``'s context at this rank's rows: its rows of W_t, its
        nodes' ``active`` and ``local_mask``; the knobs as host scalars.
        Every model rank of a node gets the same rows."""
        m = self.mesh
        dev, rows = m.device, slice(m.lo, m.hi)
        return RoundCtx(
            w=torch.as_tensor(schedule.w[r][rows], dtype=torch.float32, device=dev),
            active=torch.as_tensor(schedule.active[r][rows], device=dev),
            local_mask=torch.as_tensor(schedule.local_mask[r][:, rows], device=dev),
            pattern=int(schedule.pattern[r]),
            comp_scale=None if schedule.comp_scale is None else schedule.comp_scale[r],
            trigger=None if schedule.trigger is None else schedule.trigger[r],
        )

    # ---- state and batches --------------------------------------------------
    def init_state(self, seed: int = 0, params: Optional[Tree] = None) -> Any:
        """The initial state at this rank's rows: the model's full
        parameters from ``seed`` (or ``params``, e.g. the reference's carried
        across by ``convert.params_from_numpy``), this rank's shard of each
        kept (over both axes under '2d'), broadcast over this rank's nodes,
        then the channel's wire state (all N rows for a replicated wire)."""
        m = self.mesh
        if params is None:
            params = self.model.init(seed, device=m.device)
        leaves, treedef = tree_flatten(params)
        shards = [shard_leaf(p.to(m.device), d, m, dd)
                  for p, d, dd in zip(leaves, self.shard_dims, self.data_dims)]
        stacked = tree_unflatten(treedef, [
            p.unsqueeze(0).repeat((m.n_local,) + (1,) * p.dim()) for p in shards])
        return attach_channel_state(self.algorithm, self.algorithm.init(stacked),
                                    n_nodes=self.n_nodes)

    def full(self, tree: Tree) -> Tree:
        """A parameter-shaped node-stacked tree of this rank's rows and
        shards (the parameters, or any buffer of the state) gathered over
        every axis: all N nodes, whole leaves, on every rank (a collective:
        every rank calls it)."""
        dims = [None if d is None else d + 1 for d in self.shard_dims]
        data = [None if d is None else d + 1 for d in self.data_dims]
        return self.mesh.full(tree, dims, data)

    def full_state(self, state) -> Any:
        """The whole state on every rank (a collective: every rank calls
        it): each parameter-shaped buffer as :meth:`full` gathers it, the
        channel's wire too (replicas and residuals with the parameters'
        ``shard_dims`` and ``data_dims``, in-flight payloads through each
        leaf's codec over its shard's groups; a replicated wire already
        holds all N rows), its per-node vectors at all N rows; host values
        as they are.  The reference's state, which ``save_checkpoint`` writes in
        its format."""
        chan = self.algorithm.comm.resolved_channel()
        fields = {}
        for f in dataclasses.fields(type(state)):
            v = getattr(state, f.name)
            if isinstance(v, ChannelState):
                v = ChannelState(wire=tuple(
                    None if w is None else self._full_wire(w, chan.for_buffer(i))
                    for i, w in enumerate(v.wire)), event=v.event)
            elif isinstance(v, dict):
                v = self.full(v)
            fields[f.name] = v
        return type(state)(**fields)

    def _full_wire(self, wire: dict, chan) -> dict:
        replicated = getattr(chan, "replicated_wire", False)
        dims = [None if d is None else d + 1 for d in self.shard_dims]
        data = [None if d is None else d + 1 for d in self.data_dims]
        m = self.mesh
        codecs = chan.compression

        def params_like(tree):
            if not replicated:
                return self.full(tree)
            # all N rows already: the shards gathered over the model group,
            # then over the data group
            leaves, treedef = tree_flatten(tree)
            if m.model_group is not None:
                leaves = m.model_group.all_gather(leaves, dims)
            if m.data_group is not None:
                leaves = m.data_group.all_gather(leaves, data)
            return tree_unflatten(treedef, leaves)

        def payload(tree):
            if codecs is not None and m.node_group is not None:
                leaves, treedef = tree_flatten(tree)
                tree = tree_unflatten(treedef, [
                    codecs.for_leaf(i).whole(p)
                    if isinstance(p, Packed) and isinstance(codecs.for_leaf(i), AtShard) else p
                    for i, p in enumerate(leaves)])
            return tree if replicated else self.mesh.full(tree)

        out = {}
        for k, v in wire.items():
            if k in ("res", "hat"):
                out[k] = params_like(v)
            elif k == "nbr":
                out[k] = tuple(params_like(t) for t in v)
            elif k == "fly":
                out[k] = {fk: (tuple(payload(t) for t in fv) if isinstance(fv, tuple)
                               else payload(fv)) for fk, fv in v.items()}
            else:   # per-node vectors (ages, send masks)
                out[k] = v if replicated else self.mesh.full(v)
        return out

    def local_batch(self, global_batches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's nodes of ``(round_len, N, b, ...)`` batches (numpy
        arrays or tensors), as tensors on the mesh's device: every model
        and data rank of a node gets the node's whole batch, of which a
        '2d' data rank computes its rows (see the module docstring)."""
        m = self.mesh

        def rows(v):
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            return t[:, m.lo:m.hi].to(m.device)

        return {k: rows(v) for k, v in global_batches.items()}


def _layout(abstract_state, alg, params, param_spec=None, node_spec=None) -> Any:
    """``TrainJob.state_layout``: ``abstract_state``'s structure with every
    tensor's layout (the reference's ``state_shardings``); ``param_spec``
    (on a model axis) is the parameter-shaped buffers' spec tree, which a
    channel's params-shaped wire takes too, and ``node_spec`` a per-node
    vector's."""
    chan = alg.comm.resolved_channel()
    fields = {}
    for f in dataclasses.fields(type(abstract_state)):
        v = getattr(abstract_state, f.name)
        if isinstance(v, ChannelState):
            fields[f.name] = ChannelState(
                wire=tuple(chan.for_buffer(i).wire_spec(params, param_spec, node_spec)
                           for i in range(len(v.wire))),
                event="host")
        elif isinstance(v, int):
            fields[f.name] = "host"
        elif param_spec is not None and v is not None:
            fields[f.name] = param_spec
        else:
            fields[f.name] = map_tensors(lambda _: "node", v)
    return type(abstract_state)(**fields)


def _refuse_layout(profile: ShardingProfile, mesh) -> None:
    """The layouts a mesh does not hold (ValueError)."""
    if profile.name == "2d" and (mesh.model > 1 or mesh.data > 1):
        if not mesh.data_axis and mesh.world > 1:
            raise ValueError(
                "the '2d' profile lays a node over data x model ranks: make the mesh with "
                "its data axis (NodeMesh(..., data=D)); its node axis here has "
                f"{mesh.world} ranks")
    if profile.name != "2d" and mesh.data > 1:
        raise ValueError(f"a within-node data axis of {mesh.data} is the '2d' profile's "
                         f"layout, not {profile.name!r}'s")


def make_train_job(
    cfg: ModelConfig,
    mesh: NodeMesh,
    *,
    algorithm="dse_mvr",
    tau: int = 4,
    lr: float = 1e-3,
    alpha: float = 0.05,
    gossip: str = "roll",
    profile=None,
    state_dtype=torch.float32,
    grad_accum: int = 1,
    algorithm_kwargs: Optional[Dict[str, Any]] = None,
    scenario=None,
    use_fused: bool = False,
    compression=None,
    channel=None,
    wire_mode: str = "auto",
    overlap: bool = False,
    comm_seed_fn: Optional[SeedFn] = None,
) -> TrainJob:
    """Build a sharded decentralized training round for any registered
    algorithm (a name from ``repro_torch.core.ALGORITHMS``, or a ready
    ``DecentralizedAlgorithm``); cadence, round length and the reset
    gradient come from its ``CommSpec``.

    The keywords are the reference's.  ``use_fused=True`` routes the update
    arithmetic through the fused-op backend (``repro_torch.kernels.api``:
    kernel launches on CUDA tensors, the plain versions on the CPU).
    ``compression`` and ``channel`` set the gossip codec and protocol
    (ignored when ``algorithm`` is an instance).  ``wire_mode`` picks the
    difference channels' wire backend:

      * ``"neighbor"``  -- one replica tree per incoming shift; only the
        packed difference payload rolls (shift-structured schedules);
      * ``"allgather"`` -- the packed payload is all-gathered, the replica
        update and the W contraction run on every rank (any W_t; for the
        sync channel on the dense contraction, ``allgather_combine``);
      * ``"dense"``     -- replica trees move through the mix, dense;
      * ``"auto"``      -- neighbor on shift-structured schedules; allgather
        for choco / async with an active codec where faults rewrite W;
        dense otherwise.

    ``overlap=True`` double-buffers a choco / async channel's sends against
    the local steps.  With a ``scenario`` the step takes this rank's
    :class:`RoundCtx`; shift-structured schedules with W-preserving faults
    gossip by rotations selected by ``ctx.pattern`` (``gossip="roll"``),
    everything else by the dense contraction with W_t.

    ``comm_seed_fn(event, buffer, leaf)`` gives the codecs' uint32 seeds
    (default: ``core.simulate.default_comm_seed_fn(0)``); the port never
    re-derives the reference's threefry keys.

    ``profile`` (a ``ShardingProfile`` or its name; None: the arch's
    default, ``profile_for_arch``) lays each node out over the mesh's model
    axis, and '2d' over its data axis too (see the module docstring); on a
    mesh of one rank a node it changes nothing."""
    if profile is None:
        profile = profile_for_arch(cfg.name)
    elif isinstance(profile, str):
        profile = PROFILES[profile]
    n_nodes = mesh.n_nodes
    topology = ring(n_nodes)
    model = Model(cfg)

    if isinstance(algorithm, DecentralizedAlgorithm):
        alg = algorithm
    else:
        alg = make_algorithm(
            algorithm, lr=lr, alpha=alpha, tau=tau,
            fuse_tracking_buffers=True, state_dtype=state_dtype,
            use_fused=use_fused, compression=compression, channel=channel,
            **(algorithm_kwargs or {}),
        )
    round_len = alg.comm.round_len(getattr(alg, "tau", 1))
    if wire_mode not in ("auto", "dense", "neighbor", "allgather"):
        raise ValueError(f"wire_mode must be auto/dense/neighbor/allgather, got {wire_mode!r}")
    chan = alg.comm.resolved_channel()
    _refuse_layout(profile, mesh)
    group = mesh.model_group
    dgroup = mesh.data_group
    # each parameter leaf's spec under the profile, and its model- and
    # data-sharded dims
    with axis_rules(profile.train_rules(mesh), mesh, param_rules=profile.train_param_rules(mesh)):
        node_axes = profile.node_axes(mesh)
        param_spec = resolve_specs(model.param_specs(), prefix=(node_axes or None,))
    shard_dims = [None if group is None or "model" not in spec else spec.index("model") - 1
                  for spec in tree_leaves(param_spec)]
    data_dims = [None if dgroup is None or "data" not in spec else spec.index("data") - 1
                 for spec in tree_leaves(param_spec)]
    fsdp = group is not None and profile.name == "fsdp"
    tp = group if group is not None and profile.name in ("tp", "2d") else None
    if overlap:
        if not isinstance(chan, ChocoChannel):
            raise ValueError(
                "overlap=True requires a choco/async channel (got "
                f"{getattr(chan, 'name', None)!r}): sync gossip has no replica to mix "
                "against while the message is in flight")
        alg = dataclasses.replace(alg, channel=dataclasses.replace(chan, overlap=True))
        chan = alg.comm.resolved_channel()
    # this rank's codec numbers its noise from its first global node, and on
    # a node of several ranks each leaf's codec is bound to its shard of the
    # whole leaf: over the model group, the data group or both
    bound = None if chan is None else chan.at_rows(mesh.lo)
    if bound is not None and mesh.node_group is not None:
        def shard(d, dd, w):
            if d is None and dd is None:
                return None
            if dd is None:
                return Shard(group, d, w)
            if d is None:
                return Shard(dgroup, dd, w)
            return Shard(mesh.node_group, d, w, data_dim=dd)

        whole = tree_leaves(model.param_shapes(dtype=torch.float32))
        bound = bound.at_shards([shard(d, dd, tuple(w.shape))
                                 for d, dd, w in zip(shard_dims, data_dims, whole)],
                                node=mesh.node_group)
    if bound is not chan:
        alg = dataclasses.replace(alg, channel=bound)
        chan = alg.comm.resolved_channel()

    def _rebind_channel(**updates):
        """Rewire the difference channel's wire mode and rebuild the
        algorithm, so that the executor and the state see one channel."""
        nonlocal alg, chan
        alg = dataclasses.replace(alg, channel=dataclasses.replace(chan, **updates))
        chan = alg.comm.resolved_channel()

    # the sync channel encodes the buffers themselves and its packed
    # payloads move through the payload combine; difference / stale channels
    # encode replica differences and deliver through the wire hooks
    comp = chan.compression if isinstance(chan, SyncChannel) else None
    diff_chan = isinstance(chan, ChocoChannel)
    diff_codec = diff_chan and chan.compression is not None and not chan.compression.is_identity
    compressed_combine = None   # None: mix the decoded messages
    hooks: Dict[str, Any] = {}

    def _replicated_wire():
        """The compressed allgather's wire: held replicated, fed by
        all-gathered payloads."""
        _rebind_channel(replicated_wire=True)
        hooks.update(gather_payload=replicate_gather(mesh), pin_replicated=replicate_pin(mesh),
                     run_local=replicated_local(mesh), pin_node=node_pin(mesh))

    if scenario is not None:
        scenario.warn_if_vacuous(round_len, runtime_batches=True)
        rotations = (None if scenario.mutates_w or n_nodes == 1
                     else scenario.topology_schedule(n_nodes).rotations())
        if n_nodes == 1:
            mix_fn = lambda tree, ctx: tree  # noqa: E731
        elif gossip == "roll" and rotations and wire_mode != "allgather":
            mix_fn = scheduled_rotation_mix(rotations, mesh)
            if comp is not None:
                compressed_combine = rotation_combine(comp, rotations, scheduled=True, mesh=mesh)
            if diff_chan and wire_mode in ("auto", "neighbor"):
                ex = neighbor_exchange(rotations, scheduled=True, mesh=mesh)
                _rebind_channel(neighbor_shifts=ex.shifts)
                hooks["neighbor"] = ex
        elif gossip in ("roll", "dense"):
            mix_fn = scheduled_dense_mix(mesh)
            # "auto" gathers payloads only where the fallback used to be
            # dense with no wire win: fault-rewritten W on the roll backend
            rewritten = gossip == "roll" and scenario.mutates_w
            want_ag = wire_mode == "allgather" or (wire_mode == "auto" and rewritten)
            if want_ag and comp is not None:
                compressed_combine = allgather_combine(comp, mesh, scheduled=True)
            if want_ag and diff_codec:
                _replicated_wire()
        else:
            raise ValueError(gossip)
    elif n_nodes == 1:
        mix_fn = identity_mix
    elif gossip == "dense" or (gossip == "roll" and wire_mode == "allgather"):
        mix_fn = dense_mix(topology.w, mesh=mesh)
        if wire_mode == "allgather":
            if comp is not None:
                compressed_combine = allgather_combine(comp, mesh, w=topology.w)
            if diff_codec:
                _replicated_wire()
    elif gossip == "roll":
        rotation = Rotation.from_topology(topology)
        mix_fn = roll_mix(topology, mesh)
        if comp is not None:
            compressed_combine = rotation_combine(comp, (rotation,), mesh=mesh)
        if diff_chan and wire_mode in ("auto", "neighbor"):
            ex = neighbor_exchange((rotation,), scheduled=False, mesh=mesh)
            _rebind_channel(neighbor_shifts=ex.shifts)
            hooks["neighbor"] = ex
    else:
        raise ValueError(gossip)

    if isinstance(chan, ChocoChannel):
        # the replica trees are GBs a node at full width; step_fn's caller
        # gives up the state it passes, so they advance in their own storage
        _rebind_channel(in_place=True)

    # ---- per-node loss and gradients, a loop over this rank's nodes ----
    def share(node: Dict[str, torch.Tensor]):
        """fsdp: this model rank's rows of a node batch, or None where every
        rank computes the whole of it (see the module docstring)."""
        b = next(iter(node.values())).shape[0]
        if b % group.size or "mask" in node or "moe" in cfg.block_unit:
            return None
        n = b // group.size
        return {k: v[group.index * n:(group.index + 1) * n] for k, v in node.items()}

    def node_grads(params: Tree, batch: Dict[str, torch.Tensor], losses=None) -> Tree:
        """Each node's gradient of its own loss, stacked; ``grad_accum``
        microbatches accumulate in fp32.  ``losses`` collects each node's
        loss (the first microbatch's with accumulation, the value the
        reference's metrics read).  Under fsdp the loss and the gradient
        are those of the whole tree gathered over the model group, the
        gradient reduce-scattered back to this rank's shards; under '2d'
        those of the tree gathered over the data group, on this data rank's
        rows of each microbatch (see the module docstring)."""
        leaves, treedef = tree_flatten(params)
        out = [torch.empty_like(p) for p in leaves]
        for i in range(leaves[0].shape[0]):
            node = {k: v[i] for k, v in batch.items()}
            mine = share(node) if fsdp else None
            if mine is not None:
                node = mine
            b = next(iter(node.values())).shape[0]
            if b % grad_accum:
                raise ValueError(f"per-node batch {b} does not split into {grad_accum} "
                                 "microbatches")
            mb = b // grad_accum
            # '2d': this data rank's rows of each microbatch, where they split
            split = dgroup is not None and mb % dgroup.size == 0 and "mask" not in node
            if fsdp:
                whole = group.all_gather([p[i] for p in leaves], shard_dims)
            elif dgroup is not None:
                whole = dgroup.all_gather([p[i] for p in leaves], data_dims)
            else:
                whole = [p[i] for p in leaves]
            acc = None
            for j in range(grad_accum):
                p_i = [p.detach().requires_grad_(True) for p in whole]
                part = {k: v[j * mb:(j + 1) * mb] for k, v in node.items()}
                kw = {}
                if split:
                    n = mb // dgroup.size
                    part = {k: v[dgroup.index * n:(dgroup.index + 1) * n] for k, v in part.items()}
                    kw["data"] = dgroup
                with torch.enable_grad():
                    loss = model.loss(tree_unflatten(treedef, p_i), part, dtype=torch.bfloat16,
                                      tp=tp, **kw)
                    # a leaf the loss does not read (HuBERT's token
                    # embedding) gets a zero gradient, as under jax.grad
                    g = torch.autograd.grad(loss, p_i, materialize_grads=True)
                if losses is not None and j == 0:
                    loss = loss.detach().float()
                    if mine is not None:
                        loss = group.all_reduce(loss) / group.size
                    if split:      # the data ranks' shares of the node's loss
                        loss = dgroup.all_reduce(loss)
                    losses.append(loss)
                if grad_accum == 1:
                    acc = g
                elif acc is None:
                    acc = [gi.float() for gi in g]
                else:
                    acc = [a + gi.float() for a, gi in zip(acc, g)]
            del whole, p_i
            if mine is not None:
                acc = [a / group.size for a in group.reduce_scatter(acc, shard_dims)]
            elif fsdp:
                acc = [shard_leaf(a, d, mesh) for a, d in zip(acc, shard_dims)]
            elif split:
                acc = dgroup.reduce_scatter(acc, data_dims)
            elif dgroup is not None:
                acc = [shard_leaf(a, None, mesh, d) for a, d in zip(acc, data_dims)]
            for o, a in zip(out, acc):
                o[i].copy_(a if grad_accum == 1 else a / grad_accum)
        return tree_unflatten(treedef, out)

    loss_cell: list = []

    def comm_grad(params, batch):
        """The comm step's gradients, recording the nodes' losses."""
        losses: list = []
        grads = node_grads(params, batch, losses)
        loss_cell.append(torch.stack(losses).sum())
        return grads

    round_step, _ = make_round_step(
        alg, mix_fn, grad_of_batch=node_grads,
        comm_seed_fn=comm_seed_fn or default_comm_seed_fn(0),
        comm_grad_of_batch=comm_grad,
        scheduled=scenario is not None,
        gate_local=scenario.needs_local_gate if scenario is not None else True,
        gate_active=scenario.needs_active_gate if scenario is not None else True,
        compressed_combine=compressed_combine,
        transport_hooks=hooks or None,
    )

    def base_metrics(state) -> Dict[str, torch.Tensor]:
        dev = mesh.device
        direction = next((getattr(state, name) for name in ("v", "m", "u", "y")
                          if getattr(state, name, None) is not None), None)
        loss = (mesh.all_reduce_sum(loss_cell[0]) / n_nodes if loss_cell
                else torch.zeros((), device=dev))
        v_norm = torch.zeros((), device=dev)
        if direction is not None:
            # on a model (data) axis: the shards' squares summed over the
            # group, a leaf replicated over it once
            v_norm = sum((torch.sum(v.float() ** 2)
                          for v, d, dd in zip(tree_leaves(direction), shard_dims, data_dims)
                          if (d is not None or group is None or group.index == 0)
                          and (dd is not None or dgroup is None or dgroup.index == 0)), v_norm)
            if group is not None:
                v_norm = group.all_reduce(v_norm)
            if dgroup is not None:
                v_norm = dgroup.all_reduce(v_norm)
            v_norm = mesh.all_reduce_sum(v_norm)
        return {"loss": loss, "v_norm": v_norm}

    stream_fn = None
    if scenario is not None:
        from ..scenarios.metrics import make_stream_fn  # lazy: launch <- scenarios

        # the runtime's reference is the buffer mean (no full-batch closure)
        stream_fn = make_stream_fn(buffer_name=getattr(alg, "tracking_buffer", None),
                                   comm_buffers=alg.comm.buffers, mesh=mesh,
                                   shard_dims=shard_dims if group is not None else None,
                                   data_dims=data_dims if dgroup is not None else None)

    def step_fn(state, batches: Dict[str, torch.Tensor], ctx: Optional[RoundCtx] = None):
        if (ctx is None) != (scenario is None):
            raise ValueError("step_fn takes a RoundCtx exactly when the job has a scenario")
        loss_cell.clear()
        steps = [{k: v[t] for k, v in batches.items()} for t in range(round_len)]
        state = round_step(state, steps) if ctx is None else round_step(state, steps, ctx)
        metrics = base_metrics(state)
        if stream_fn is not None:
            metrics.update(stream_fn(state, ctx))
        return state, metrics

    # ---- the abstract state: meta tensors, nothing allocated ----
    leaves, treedef = tree_flatten(model.param_shapes(dtype=torch.float32))
    stacked = tree_unflatten(treedef, [
        torch.empty((mesh.n_local,) + tuple(shard_leaf(s, d, mesh, dd).shape), dtype=s.dtype,
                    device="meta") for s, d, dd in zip(leaves, shard_dims, data_dims)])
    abstract_state = abstract_channel_state(alg, alg.init(stacked), n_nodes=n_nodes)

    return TrainJob(
        model=model, mesh=mesh, algorithm=alg,
        tau=int(getattr(alg, "tau", 1)), round_len=round_len, n_nodes=n_nodes,
        gossip=gossip, step_fn=step_fn, abstract_state=abstract_state,
        state_layout=_layout(abstract_state, alg, stacked,
                             param_spec if group is not None or dgroup is not None else None,
                             (node_axes or None,) if group is not None or dgroup is not None
                             else None),
        profile=profile, shard_dims=shard_dims, scenario=scenario, data_dims=data_dims,
    )
