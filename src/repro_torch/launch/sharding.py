"""Sharding profiles: how each architecture maps onto a data x model mesh.

Counterpart of ``repro.launch.sharding``.  A profile decides (a) which mesh
axes form the decentralized *node* axis (the paper's network nodes:
parameters are distinct across it between communication rounds) and (b)
the within-node layout of parameters and activations:

  'tp'    nodes = all data-parallel axes; within a node, feature dims
          (ffn / heads / vocab / experts) shard over 'model' and every
          model rank sees the whole node batch (Megatron tensor parallel).
  'fsdp'  nodes = data axes; parameters shard their 'embed' dim over
          'model' and the node batch shards over 'model' (each rank
          gathers the parameters before its forward: ZeRO-3).
  '2d'    for models too big for one slice: nodes = ('pod',) only, the
          parameters sharded over both axes.  The port refuses it on a
          model axis larger than 1 (ROADMAP queue 1 item 8 (b)); 'tp' and
          'fsdp' run every codec, channel and scenario there.

A spec is a tuple with one entry per dim: a mesh axis name, a tuple of
them, or None -- the entries of the reference's ``PartitionSpec``.  A mesh
is any object with ``axis_names`` and ``devices.shape`` (the port's
``NodeMesh`` offers both).  Serving ('serve' rules) has no node axis: the
batch shards over all data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["ShardingProfile", "PROFILES", "ARCH_PROFILE", "profile_for_arch", "cache_specs",
           "shard_leaf", "param_shard", "cache_shard"]


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    name: str

    def data_axes(self, mesh) -> Tuple[str, ...]:
        return tuple(a for a in mesh.axis_names if a in ("pod", "data"))

    def node_axes(self, mesh) -> Tuple[str, ...]:
        if self.name == "2d":
            return ("pod",) if "pod" in mesh.axis_names else ()
        return self.data_axes(mesh)

    def n_nodes(self, mesh) -> int:
        shape = _axis_sizes(mesh)
        n = 1
        for a in self.node_axes(mesh):
            n *= shape[a]
        return n

    # -- rules tables ------------------------------------------------------
    def train_rules(self, mesh) -> Dict[str, Any]:
        """Activation rules of the training step."""
        if self.name == "tp":
            return {
                "batch": None, "ffn": "model", "heads": "model",
                "kv_heads": "model", "vocab": "model", "experts": "model",
                "heads_flat": "model", "ssm_in": "model", "embed": None,
            }
        if self.name == "fsdp":
            # 'seq' is the reference's fallback where the node batch does
            # not divide by the model axis; the port computes the whole
            # node batch on every model rank there instead (same function)
            return {"batch": "model", "seq": "model", "embed": None,
                    "ffn": None, "vocab": "model"}
        if self.name == "2d":
            return {
                "batch": "data", "ffn": "model", "heads": "model",
                "kv_heads": "model", "vocab": "model", "experts": "model",
                "expert_cap": "data", "expert_group": "data",
                "heads_flat": "model", "ssm_in": "model", "embed": None,
            }
        raise ValueError(self.name)

    def train_param_rules(self, mesh) -> Dict[str, Any]:
        if self.name == "tp":
            return {
                "ffn": "model", "heads": "model", "kv_heads": "model",
                "vocab": "model", "experts": "model", "heads_flat": "model",
                "ssm_in": "model", "embed": None, "layers": None,
            }
        if self.name == "fsdp":
            return {"embed": "model", "vocab": "model", "experts": "model", "layers": None}
        if self.name == "2d":
            return {
                "experts": "data", "embed": "data",
                "ffn": "model", "heads": "model", "kv_heads": "model",
                "vocab": "model", "heads_flat": "model", "ssm_in": "model",
                "layers": None,
            }
        raise ValueError(self.name)

    # serving: one logical model, batch over all data axes, TP over model
    def serve_rules(self, mesh) -> Dict[str, Any]:
        batch_axes = self.data_axes(mesh)
        return {
            "batch": batch_axes if batch_axes else None,
            "ffn": "model", "heads": "model", "kv_heads": "model",
            "vocab": "model", "experts": "model", "heads_flat": "model",
            "ssm_in": "model", "embed": None,
        }

    def serve_param_rules(self, mesh) -> Dict[str, Any]:
        return {
            "ffn": "model", "heads": "model", "kv_heads": "model",
            "vocab": "model", "experts": "model", "heads_flat": "model",
            "ssm_in": "model", "embed": None, "layers": None,
        }


PROFILES = {name: ShardingProfile(name) for name in ("tp", "fsdp", "2d")}

# each architecture's default profile, the reference's table
ARCH_PROFILE = {
    "arctic-480b": "2d",
    "command-r-plus-104b": "2d",
    "qwen2-moe-a2.7b": "tp",
    "zamba2-7b": "tp",
    "qwen2-vl-2b": "tp",
    "gemma2-2b": "tp",
    "yi-9b": "fsdp",
    "rwkv6-3b": "tp",
    "hubert-xlarge": "tp",
    "minitron-8b": "fsdp",
}


def profile_for_arch(name: str) -> ShardingProfile:
    """The default profile of an arch id (CLI ids keep their dots; a
    ``-reduced`` suffix and underscores are read as the full arch's id);
    'tp' for an unknown one."""
    base = name.replace("_", "-").replace("-reduced", "")
    return PROFILES[ARCH_PROFILE.get(base, "tp")]


# ---------------------------------------------------------------- caches
def cache_specs(cache: Any, batch_axes, model_axis="model", mesh=None,
                seq_shard_axes=None) -> Any:
    """The spec tree of a decode-cache tree (stacked over repeats), by leaf
    name.  Leaf layouts after the leading repeats dim:

      k/v   (B, S, K, D)   -> (None, batch, seq, model-if-divisible, None)
      pos   (B, S)         -> (None, batch, seq)
      conv  (B, W, C)      -> (None, batch, None, model)
      ssm   (B, H, P, N)   -> (None, batch, model, None, None)
      wkv   (B, H, P, P)   -> (None, batch, model, None, None)
      shift (B, 1, d)      -> (None, batch, None, None)

    An axis that does not divide its dim (with ``mesh`` given) drops to
    None; ``seq_shard_axes`` shards the KV sequence where the batch cannot
    shard (the reference's long-context decode at batch 1; the serve job
    never passes it, as only the reference's ``launch/dryrun.py`` does).
    The mesh-sharded serve job (``launch/serve.py``) lays its decode caches
    out by this tree: ``ServeJob.init_cache`` cuts a rank's shard with
    :func:`cache_shard`, and the model's prefill and decode produce and
    read caches in that layout (a rank's KV heads, or all of them where K
    does not divide by the model axis; its contiguous block of the conv
    window's channels; its heads' states)."""
    sizes = _axis_sizes(mesh) if mesh is not None else {}

    def axis_ok(size, ax):
        if mesh is None or ax is None:
            return True
        n = 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            n *= sizes[a]
        return size % n == 0

    def spec_for(name, leaf):
        shp = tuple(leaf.shape)      # includes the leading repeats dim
        b_ax = batch_axes if axis_ok(shp[1], batch_axes) else None
        s_ax = None
        if seq_shard_axes and b_ax is None and axis_ok(shp[2], seq_shard_axes):
            s_ax = seq_shard_axes
        if name in ("k", "v"):
            m = model_axis if axis_ok(shp[3], model_axis) else None
            return (None, b_ax, s_ax, m, None)
        if name == "pos":
            return (None, b_ax, s_ax)
        if name == "conv":
            m = model_axis if axis_ok(shp[3], model_axis) else None
            return (None, b_ax, None, m)
        if name in ("ssm", "wkv"):
            m = model_axis if axis_ok(shp[2], model_axis) else None
            return (None, b_ax, m, None, None)
        if name in ("shift_t", "shift_c"):
            return (None, b_ax, None, None)
        return (None,) * len(shp)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_for(name, tree)

    return walk(cache)


# ---------------------------------------------------------------- shards
def shard_leaf(p, dim: Optional[int], mesh):
    """A rank's model shard of a whole leaf along ``dim`` (None: the whole
    of it): part ``m`` of M along it, for model index m of ``mesh``."""
    if dim is None:
        return p
    n = p.shape[dim] // mesh.model
    return p.narrow(dim, mesh.model_group.index * n, n).contiguous()


def param_shard(params: Any, specs: Any, mesh) -> Any:
    """A rank's shard of a whole parameter tree laid out by ``specs`` (a
    spec tree with no data axis, as ``resolve_specs`` gives it under
    ``serve_param_rules``): each leaf's model shard (:func:`shard_leaf`)."""
    if mesh is None or mesh.model == 1:
        return params
    leaves, treedef = tree_flatten(params)
    dims = [None if "model" not in spec else spec.index("model") for spec in tree_leaves(specs)]
    return tree_unflatten(treedef, [shard_leaf(p, d, mesh) for p, d in zip(leaves, dims)])


def cache_shard(cache: Any, specs: Any, mesh) -> Any:
    """A rank's shard of a whole decode-cache tree laid out by ``specs``
    (:func:`cache_specs`' tree): along a data axis (``"data"``, or a tuple
    of the data axes) its data rank's part, along ``"model"`` its model
    index's part."""
    def part(x, spec):
        for dim, ax in enumerate(spec):
            for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
                size, index = ((mesh.model, mesh.model_group.index) if a == "model"
                               else (mesh.world, mesh.rank))
                if size > 1:
                    n = x.shape[dim] // size
                    x = x.narrow(dim, index * n, n)
        return x.contiguous()

    leaves, treedef = tree_flatten(cache)
    return tree_unflatten(treedef, [part(x, s) for x, s in zip(leaves, tree_leaves(specs))])
