"""Model assembly: a repeating ``block_unit`` of layer kinds, ``repeats``
times, with an embedding in front and an LM head behind.

Counterpart of ``repro.models.transformer`` for the kinds the port has:

  'attn'         full attention + dense FFN
  'local'        sliding-window attention + dense FFN (Gemma-2's local layers)
  'moe'          full attention + mixture-of-experts FFN (Qwen2-MoE, Arctic)
  'mamba'        Mamba-2 SSD mixer block
  'rwkv'         RWKV-6 time-mix + channel-mix (RWKV-6 3B)
  'shared_attn'  attention + FFN whose weights are shared across repeats
                 (Zamba2's shared transformer block)

Two front ends, as in the reference, each a projection standing in for
the modality's encoder: audio frames (B, S, F) through ``audio_proj``
(HuBERT; positions ``arange(S)``), and vision embeddings (B, n_vis, d)
through ``vision_proj``, placed before the token embeddings, with
Qwen2-VL's M-RoPE positions (3, B, S).  Heads: 'lm' (causal LM) and
'frame' (HuBERT's per-frame classifier), which is the untied ``lm_head``
over every frame, with no code path of its own.

Parameters are a plain dict tree with the reference's names and its stacked
layout -- every block element's leaves carry a leading ``(repeats,)`` axis,
except a 'shared_attn' element's, which is one copy used at every repeat
-- so ``convert.params_from_numpy`` carries the reference's parameters over
unchanged.  The reference's ``lax.scan`` over repeats is a Python loop that
indexes the stacked leaves.  Entry points: ``forward`` / ``loss`` (training
and evaluation; a MoE block adds its router losses to the auxiliary loss
there), ``prefill`` (build caches from a prompt) and ``decode_step`` (one
token against the caches: ring buffers for attention, recurrent states for
Mamba-2 and RWKV-6, every element's stacked over repeats).  ``loss`` is
differentiable with respect to the parameters: the kernels' ops backward
through their plain versions (``kernels/api.py``).  The config's ``remat``
field is not read: the port keeps every activation for the backward.
``init`` and
``init_cache`` make tensors on CUDA unless the caller asks for the CPU;
the rest follow their inputs' device.

``forward``, ``loss``, ``prefill`` and ``decode_step`` take ``tp``, a model
group (``launch/mesh.py``'s ``ModelGroup``), for a node (or a served
model) spread tensor-parallel over M ranks: each rank
holds its shard of the parameters, as the 'tp' profile lays them out, and
the model reads the layout off the shards' shapes.  The embedding is
vocab-parallel (each rank looks up its rows and the lookups are summed),
attention takes the rank's heads, the dense MLP its hidden units (their
partial outputs all-reduced in fp32), the MoE block the rank's experts
(``mlp.py``), the Mamba-2 block its SSM heads (``mamba.py``), the RWKV
block its time-mix heads and channel-mix hidden units (``rwkv.py``); the
head gives vocab-sharded logits and the loss reduces over the vocabulary's
shards (``cross_entropy_loss(..., tp=)``).  The audio front end's
projection is replicated and runs whole on every rank.  A layer whose
parallel dim fell back to replicated runs whole on every rank.  Every rank
sees the whole batch.  ``prefill`` and ``decode_step`` return the whole
vocabulary's logits, the ranks' shards gathered in rank order (the same
bits on every rank), and read and write the rank's decode caches as
``launch/sharding.py``'s ``cache_specs`` lays them out (the serve job,
``launch/serve.py``).  They also take ``data``, the serve job's mesh where
it splits one batch over its data ranks: the only rows that interact are
a MoE block's, whose queues run over the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import attention as attn_lib
from . import mamba as mamba_lib
from . import mlp as mlp_lib
from . import rwkv as rwkv_lib
from .common import (Initializer, cross_entropy_loss, make_mrope_positions, rms_norm,
                     softcap)

Tree = Any

__all__ = ["ModelConfig", "Model"]

KINDS = ("attn", "local", "moe", "shared_attn", "mamba", "rwkv")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig``: the same fields and defaults
    (``param_dtype`` a ``torch.dtype``)."""

    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    block_unit: Tuple[str, ...] = ("attn",)
    causal: bool = True
    head: str = "lm"               # 'lm' | 'frame'
    tie_embeddings: bool = True
    scale_embeddings: bool = False
    activation: str = "silu"
    norm_plus_one: bool = False    # gemma convention
    use_post_norm: bool = False    # gemma2 post-block norms
    use_bias: bool = False
    qk_norm: bool = False
    # attention
    sliding_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attn_impl: str = "xla"
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    moe_dispatch: str = "auto"
    # ssm
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # modality frontends
    n_vision_tokens: int = 0
    vision_grid: Tuple[int, int] = (16, 16)
    audio_frontend_dim: int = 0
    # numerics
    param_dtype: Any = torch.float32
    rwkv_chunk: int = 0
    rwkv_chunk_bf16: bool = False
    rwkv_pallas: bool = False
    remat: str = "block"

    def __post_init__(self):
        if self.n_layers % len(self.block_unit):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"block unit {self.block_unit}"
            )

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.block_unit)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self, kind: str) -> attn_lib.AttentionConfig:
        return attn_lib.AttentionConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.hd,
            causal=self.causal,
            sliding_window=self.sliding_window if kind == "local" else None,
            attn_softcap=self.attn_softcap,
            rope_theta=self.rope_theta,
            mrope_sections=self.mrope_sections,
            use_bias=self.use_bias,
            qk_norm=self.qk_norm,
            attn_impl=self.attn_impl,
        )

    def mlp_cfg(self) -> mlp_lib.MLPConfig:
        return mlp_lib.MLPConfig(self.d_model, self.d_ff, self.activation, self.use_bias)

    def moe_cfg(self) -> mlp_lib.MoEConfig:
        return mlp_lib.MoEConfig(
            d_model=self.d_model,
            d_ff=self.moe_d_ff or self.d_ff,
            n_experts=self.n_experts,
            top_k=self.top_k,
            n_shared_experts=self.n_shared_experts,
            dense_residual=self.dense_residual,
            dense_d_ff=self.d_ff,
            capacity_factor=self.capacity_factor,
            activation=self.activation,
            dispatch_layout=self.moe_dispatch,
        )

    def mamba_cfg(self) -> mamba_lib.MambaConfig:
        return mamba_lib.MambaConfig(
            d_model=self.d_model,
            d_inner=self.ssm_expand * self.d_model,
            state_dim=self.ssm_state,
            head_dim=self.ssm_head_dim,
            chunk=self.ssm_chunk,
        )

    def rwkv_cfg(self) -> rwkv_lib.RWKVConfig:
        return rwkv_lib.RWKVConfig(
            self.d_model, self.d_ff, head_dim=64, chunk=self.rwkv_chunk,
            chunk_bf16=self.rwkv_chunk_bf16, use_pallas=self.rwkv_pallas,
        )

    def param_count(self, params: Tree) -> int:
        return sum(int(p.numel()) for p in tree_leaves(params))


def _unstack(tree: Tree, n: int) -> list:
    """A tree of ``(n, ...)``-stacked leaves as ``n`` trees of views, one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a full-size gradient per layer."""
    leaves, treedef = tree_flatten(tree)
    cols = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [c[r] for c in cols]) for r in range(n)]


class Model:
    """Functional model bound to a ModelConfig."""

    def __init__(self, cfg: ModelConfig):
        for kind in cfg.block_unit:
            if kind not in KINDS:
                raise ValueError(kind)
        self.cfg = cfg

    # ------------------------------------------------------------------
    # parameter construction
    # ------------------------------------------------------------------
    def _init_element(self, kind: str, ini: Initializer) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        p: Dict[str, Any] = {"norm1": ini.param((d,), ("embed",), init="ones")}
        if kind == "rwkv":
            p["norm2"] = ini.param((d,), ("embed",), init="ones")
            p["rwkv"] = rwkv_lib.init_rwkv(cfg.rwkv_cfg(), ini)
            return p
        if kind == "mamba":
            p["mamba"] = mamba_lib.init_mamba(cfg.mamba_cfg(), ini)
            return p
        p["attn"] = attn_lib.init_attention(cfg.attn_cfg(kind), ini)
        p["norm2"] = ini.param((d,), ("embed",), init="ones")
        if kind == "moe":
            p["ffn"] = mlp_lib.init_moe(cfg.moe_cfg(), ini)
        else:
            p["ffn"] = mlp_lib.init_mlp(cfg.mlp_cfg(), ini)
        if cfg.use_post_norm:
            p["post_norm1"] = ini.param((d,), ("embed",), init="ones")
            p["post_norm2"] = ini.param((d,), ("embed",), init="ones")
        return p

    def init(self, seed: int = 0, dtype=None, device=None) -> Tree:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device; not the reference's ``jax.random`` numbers)."""
        dev = resolve_device(device)
        return self._init_with(Initializer(torch.Generator(device=dev).manual_seed(int(seed)),
                                           dtype or self.cfg.param_dtype, dev))

    def param_shapes(self, dtype=None) -> Tree:
        """The parameter tree as meta tensors: shapes and dtypes, nothing
        allocated (the reference's ``param_shapes``)."""
        return self._init_with(Initializer(torch.Generator(), dtype or self.cfg.param_dtype,
                                           "meta"))

    def param_specs(self) -> Tree:
        """The parameter tree's :class:`~repro_torch.models.common.LogicalAxes`
        (resolve them under ``axis_rules`` with ``resolve_specs``): the
        reference's axis names, stacked block leaves led by ``"layers"``."""
        return self._init_with(Initializer(None, mode="specs"))

    def _init_with(self, ini: Initializer) -> Tree:
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": ini.param((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed",
                                scale=0.02),
        }
        if cfg.audio_frontend_dim:
            params["audio_proj"] = ini.param((cfg.audio_frontend_dim, cfg.d_model), (None, "embed"))
        if cfg.n_vision_tokens:
            params["vision_proj"] = ini.param((cfg.d_model, cfg.d_model), (None, "embed"))
        stacked = ini.stacked(cfg.repeats)
        # a shared_attn element is one copy, used at every repeat
        params["blocks"] = {
            f"b{i}": self._init_element(kind, ini if kind == "shared_attn" else stacked)
            for i, kind in enumerate(cfg.block_unit)}
        params["final_norm"] = ini.param((cfg.d_model,), ("embed",), init="ones")
        if not cfg.tie_embeddings:
            params["lm_head"] = ini.param((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                          init="normal")
        return params

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _norm(self, x, w):
        return rms_norm(x, w, plus_one=self.cfg.norm_plus_one)

    def _scale_embeddings(self, x):
        # sqrt(d_model) in fp32, cast to the activation dtype first
        root = torch.tensor(float(self.cfg.d_model), dtype=torch.float32).sqrt()
        return x * root.to(device=x.device, dtype=x.dtype)

    def _vocab_sharded(self, params, tp) -> bool:
        """True where ``tp`` is given and the rank holds a vocabulary shard
        of the head (the vocab dim divides by the model axis)."""
        w = params.get("lm_head")
        n = params["embed"].shape[0] if w is None else w.shape[-1]
        return tp is not None and n != self.cfg.vocab_size

    def _embed_tokens(self, params, tokens, dtype, tp=None):
        """The token embeddings (before the scale).  With ``tp`` and a
        vocab-sharded table: vocab-parallel, the rank's rows, zero
        elsewhere, summed over the ranks (one nonzero term: the same bits
        as the whole table)."""
        embed = params["embed"]
        if tp is not None and embed.shape[0] != self.cfg.vocab_size:
            rows = embed.shape[0]
            local = tokens - tp.index * rows
            inside = (local >= 0) & (local < rows)
            x = embed[local.clamp(0, rows - 1)].to(dtype) * inside[..., None].to(dtype)
            return tp.reduce_from(x)
        return embed[tokens].to(dtype)

    def _embed_inputs(self, params, batch, dtype=torch.bfloat16, tp=None):
        """Returns (x, positions): (B, S) int32, or (3, B, S) under M-RoPE.

        An audio model takes ``batch["frames"]`` (B, S, F) and returns
        before the embedding scale, as the reference does; a vision model
        takes ``batch["vision_embeds"]`` (B, n_vis, d) beside the tokens."""
        cfg = self.cfg
        if cfg.audio_frontend_dim:
            x = torch.einsum("bsf,fd->bsd", batch["frames"].to(dtype),
                             params["audio_proj"].to(dtype))
            b, s = x.shape[:2]
            return x, torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
        x = self._embed_tokens(params, batch["tokens"], dtype, tp)
        if cfg.n_vision_tokens:
            ve = torch.einsum("bvd,de->bve", batch["vision_embeds"].to(dtype),
                              params["vision_proj"].to(dtype))
            x = torch.cat([ve, x], dim=1)
            b, s = x.shape[:2]
            positions = make_mrope_positions(b, s, cfg.n_vision_tokens, cfg.vision_grid,
                                             device=x.device)
        else:
            b, s = x.shape[:2]
            positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
        if cfg.scale_embeddings:
            x = self._scale_embeddings(x)
        return x, positions

    def _head(self, params, x, tp=None):
        x = self._norm(x, params["final_norm"])
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].T
        if self._vocab_sharded(params, tp):
            x = tp.copy_to(x)          # logits of the rank's vocabulary shard
        logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
        return softcap(logits, self.cfg.logit_softcap)

    def _whole_logits(self, params, x, tp=None):
        """The head's logits over the whole vocabulary: with ``tp`` and a
        vocab-parallel head, the ranks' shards gathered in rank order (every
        rank of the model group gets the same bits)."""
        logits = self._head(params, x, tp=tp)
        if self._vocab_sharded(params, tp):
            logits = tp.all_gather([logits], [2])[0]
        return logits

    # ------------------------------------------------------------------
    # block application
    # ------------------------------------------------------------------
    def _apply_block(self, kind, bp, x, positions, mode, cache=None, position=None, tp=None,
                     data=None):
        """Apply one block.  mode: 'fwd' | 'prefill' | 'decode'.
        Returns (x, new_cache, aux): aux is a MoE block's router losses in
        'fwd' mode, else None.  ``tp`` and ``data``: see the module
        docstring."""
        cfg = self.cfg
        if kind == "rwkv":
            return self._apply_rwkv(bp, x, mode, cache, tp=tp) + (None,)
        if kind == "mamba":
            return self._apply_mamba(bp, x, mode, cache, tp=tp) + (None,)
        acfg = cfg.attn_cfg(kind)
        h = self._norm(x, bp["norm1"])
        if mode == "decode":
            y, new_cache = attn_lib.attention_decode(acfg, bp["attn"], h, position,
                                                     cache["attn"], tp=tp)
        elif mode == "prefill":
            y, new_cache = attn_lib.attention_forward(acfg, bp["attn"], h, positions,
                                                      return_cache=True, tp=tp)
        else:
            y, new_cache = attn_lib.attention_forward(acfg, bp["attn"], h, positions,
                                                      tp=tp), None
        if cfg.use_post_norm:
            y = self._norm(y, bp["post_norm1"])
        x = x + y
        h = self._norm(x, bp["norm2"])
        aux = None
        if kind == "moe":
            y, aux = mlp_lib.moe_forward(cfg.moe_cfg(), bp["ffn"], h, return_aux=mode == "fwd",
                                         tp=tp, data=data)
        else:
            y = mlp_lib.mlp_forward(cfg.mlp_cfg(), bp["ffn"], h, tp=tp)
        if cfg.use_post_norm:
            y = self._norm(y, bp["post_norm2"])
        x = x + y
        return x, (None if new_cache is None else {"attn": new_cache}), aux

    def _apply_mamba(self, bp, x, mode, cache=None, tp=None):
        """One Mamba-2 block behind its norm.  The cache is ``{"mamba":
        {"conv", "ssm"}}``."""
        mcfg = self.cfg.mamba_cfg()
        h = self._norm(x, bp["norm1"])
        if mode == "decode":
            y, new_cache = mamba_lib.mamba_decode(mcfg, bp["mamba"], h, cache["mamba"], tp=tp)
        elif mode == "prefill":
            y, new_cache = mamba_lib.mamba_forward(mcfg, bp["mamba"], h, return_cache=True,
                                                   tp=tp)
        else:
            y, new_cache = mamba_lib.mamba_forward(mcfg, bp["mamba"], h, tp=tp), None
        return x + y, (None if new_cache is None else {"mamba": new_cache})

    def _apply_rwkv(self, bp, x, mode, cache=None, tp=None):
        """One RWKV block: time-mix then channel-mix, each behind its norm.
        The cache is ``{"rwkv": {"wkv", "shift_t", "shift_c"}}``."""
        rcfg = self.cfg.rwkv_cfg()
        h = self._norm(x, bp["norm1"])
        if mode == "decode":
            y, tc = rwkv_lib.timemix_decode(rcfg, bp["rwkv"], h, cache["rwkv"], tp=tp)
        else:
            y, tc = rwkv_lib.timemix_forward(rcfg, bp["rwkv"], h, return_cache=True, tp=tp)
        x = x + y
        h = self._norm(x, bp["norm2"])
        if mode == "decode":
            y, cc = rwkv_lib.chanmix_decode(rcfg, bp["rwkv"], h, cache["rwkv"], tp=tp)
        else:
            y, cc = rwkv_lib.chanmix_forward(rcfg, bp["rwkv"], h, return_cache=True, tp=tp)
        x = x + y
        return x, (None if mode == "fwd" else {"rwkv": {**tc, **cc}})

    def _scan_blocks(self, params, x, positions, mode, caches=None, position=None, tp=None,
                     data=None):
        """Loop over repeats; within a repeat apply each unit element in
        order.  Returns (x, caches stacked over repeats or None, the summed
        auxiliary loss (fp32) in 'fwd' mode or None)."""
        cfg = self.cfg
        out: Dict[str, list] = {f"b{i}": [] for i in range(len(cfg.block_unit))}
        aux = torch.zeros((), dtype=torch.float32, device=x.device) if mode == "fwd" else None
        layers = {f"b{i}": _unstack(params["blocks"][f"b{i}"], cfg.repeats)
                  for i, kind in enumerate(cfg.block_unit) if kind != "shared_attn"}
        for r in range(cfg.repeats):
            for i, kind in enumerate(cfg.block_unit):
                key = f"b{i}"
                bp = params["blocks"][key] if kind == "shared_attn" else layers[key][r]
                c = None if caches is None else tree_map(lambda t: t[r], caches[key])
                x, nc, block_aux = self._apply_block(kind, bp, x, positions, mode, cache=c,
                                                     position=position, tp=tp, data=data)
                if nc is not None:
                    out[key].append(nc)
                if block_aux is not None:
                    aux = aux + block_aux
        if mode == "fwd":
            return x, aux
        return x, {key: tree_map(lambda *ts: torch.stack(ts), *layers)
                   for key, layers in out.items()}

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def forward(self, params, batch, dtype=torch.bfloat16, tp=None):
        """Logits (B, S, V) and the auxiliary loss: the MoE blocks' router
        z-losses and load-balance losses (fp32; 0 without MoE blocks).
        With ``tp`` the logits are the rank's vocabulary shard where the
        head is vocab-parallel."""
        x, positions = self._embed_inputs(params, batch, dtype, tp=tp)
        x, aux = self._scan_blocks(params, x, positions, "fwd", tp=tp)
        return self._head(params, x, tp=tp), aux

    def loss(self, params, batch, dtype=torch.bfloat16, tp=None):
        """Mean token cross entropy plus the auxiliary loss, fp32.  A vision
        model's loss reads the text positions only (after the vision
        block).  Differentiable with respect to ``params``; with ``tp``,
        every rank of the model group gets the same loss."""
        logits, aux = self.forward(params, batch, dtype, tp=tp)
        if self.cfg.n_vision_tokens:
            logits = logits[:, self.cfg.n_vision_tokens:]
        vocab_tp = tp if self._vocab_sharded(params, tp) else None
        return cross_entropy_loss(logits, batch["targets"], batch.get("mask"),
                                  tp=vocab_tp) + aux

    def prefill(self, params, batch, dtype=torch.bfloat16, tp=None, data=None):
        """Last-token logits (B, 1, V) and the prompt's caches: per block
        element ``{"attn": {"k", "v" (repeats, B, S, K, hd), "pos"
        (repeats, B, S) int32}}``, full length (not ring buffers),
        ``{"mamba": {"conv" (repeats, B, W-1, di+2N), "ssm" (repeats, B, H,
        P, N) fp32}}`` or ``{"rwkv": {"wkv" (repeats, B, H, P, P) fp32,
        "shift_t", "shift_c" (repeats, B, 1, d)}}``.

        ``tp`` (a model group): the rank's shards of a tensor-parallel
        model, as the 'tp' profile (and every profile's serve rules) lays
        them out; the logits are the whole vocabulary's on every rank, and
        the caches the rank's, as ``launch/sharding.py``'s ``cache_specs``
        lays them out.  ``data`` (a ``NodeMesh``): the batch is this data
        rank's block of rows of one batch split over the mesh's data ranks,
        which a MoE block queues as one (``models/mlp.py``)."""
        x, positions = self._embed_inputs(params, batch, dtype, tp=tp)
        x, caches = self._scan_blocks(params, x, positions, "prefill", tp=tp, data=data)
        return self._whole_logits(params, x[:, -1:], tp), caches

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        """Empty decode caches, stacked over repeats (a shared_attn
        element's too: its weights are shared, its cache is per repeat):
        ring buffers for attention; Mamba-2's conv window and SSM state and
        RWKV's state and token shifts (the states fp32 whatever ``dtype``),
        which do not depend on ``max_len``."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = {}
        for i, kind in enumerate(cfg.block_unit):
            if kind == "rwkv":
                one = {"rwkv": rwkv_lib.init_rwkv_cache(cfg.rwkv_cfg(), batch, dtype, dev)}
            elif kind == "mamba":
                one = {"mamba": mamba_lib.init_mamba_cache(cfg.mamba_cfg(), batch, dtype, dev)}
            else:
                one = {"attn": attn_lib.init_kv_cache(cfg.attn_cfg(kind), batch, max_len,
                                                      dtype, dev)}
            caches[f"b{i}"] = tree_map(
                lambda t: t.unsqueeze(0).repeat((cfg.repeats,) + (1,) * t.dim()), one)
        return caches

    def decode_step(self, params, caches, tokens, position, dtype=torch.bfloat16, tp=None,
                    data=None):
        """tokens: (B, 1) int; position: (B,) int32.  Returns (logits
        (B, 1, V), caches); the input caches are not modified.  ``tp`` and
        ``data``: as in :meth:`prefill`, against the rank's cache shards."""
        x = self._embed_tokens(params, tokens, dtype, tp)
        if self.cfg.scale_embeddings:
            x = self._scale_embeddings(x)
        x, caches_out = self._scan_blocks(params, x, None, "decode", caches=caches,
                                          position=position, tp=tp, data=data)
        return self._whole_logits(params, x, tp), caches_out
