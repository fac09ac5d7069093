"""The LM serve job, on one device or over a data x model mesh, and the
serving CLI.

Counterpart of the serving part of ``repro.launch.distributed``
(``ServeJob``, ``make_serve_job``) and of ``repro.launch.serve``.
``make_serve_job(cfg).prefill_fn`` runs ``Model.prefill`` in bf16 -- with
``attn_impl="pallas"`` every attention layer (a MoE block's and Zamba2's
shared block's too) goes through the hand-written flash-attention kernel,
and with ``replace(cfg, rwkv_chunk=16, rwkv_pallas=True)`` every RWKV-6
layer's time-mix through the hand-written wkv_chunk kernel -- and
``decode_fn`` runs ``Model.decode_step`` in bf16 against the decode caches
(ring buffers for attention, the recurrent states for RWKV-6 and Mamba-2).
Both run under ``torch.inference_mode()``.

``make_serve_job(cfg, mesh)`` serves one logical model over a
``NodeMesh(n_nodes=D, group, model=M)`` of D x M gloo ranks (rank d M + m):
the batch is split over the D data ranks, each with its own rows and
caches (where D does not divide the batch, every
data rank serves all of it, as the reference's specs fall back), and the
features over the M ranks of a model group, as the profile's
``serve_rules`` / ``serve_param_rules`` lay them out (the same for every
profile: Yi-9B and Minitron, whose training profile is 'fsdp', and the
'2d' archs serve under them too).  That is Megatron tensor parallelism:
heads, KV heads where they divide, FFN hidden units, experts, Mamba-2's SSM
heads, RWKV-6's ``heads_flat`` and the vocabulary.  A rank's parameters
are ``job.shard_params(whole)``, its rows ``job.local_batch(batch)``, its
caches ``job.init_cache(batch, max_len)`` (or its prefill's), laid out by
``cache_specs``; the logits are the whole vocabulary's, the same bits on
every rank of a model group.  Every rank calls every function (each one
has collectives).  Over 4 processes on the CPU:

  # each rank, after torch.distributed.init_process_group("gloo", ...):
  mesh = make_group_mesh(2, device="cpu", model=2)      # 2 data x model 2
  job = make_serve_job(get_reduced("gemma2-2b"), mesh)
  params = job.shard_params(job.init_params(0))
  rows = job.local_batch({"tokens": tokens})            # tokens (B, S)
  logits, caches = job.prefill_fn(params, rows, global_batch=B)
  logits, caches = job.decode_fn(params, caches, next_tokens, positions,
                                 global_batch=B)

(``next_tokens`` and ``positions`` of this data rank's rows), or a
``serving.RequestDriver(model, slots=B, ..., job=job)`` on each data rank.
The data ranks' rows meet only in a MoE block, which queues the whole
batch's entries once (``models/mlp.py``), as the reference's job does:
one exchange of the per-expert counts over the data ranks a layer.  Not
carried over: the reference's ``lower_prefill`` / ``lower_decode`` (XLA
compile artefacts; see ``launch/distributed.py``).

The CLI does what the reference's does: fp32 parameters from the seed and
fp32 caches, the prompts prefilled through ``scan_prefill`` (decode steps),
then ``--new-tokens`` of greedy (or sampled) decode, on one device (the
reference's CLI builds its job on a mesh but computes unsharded; like it,
this one prints the job's mesh and profile):

  python -m repro_torch.launch.serve --arch gemma2-2b --reduced --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-3b --reduced --device cpu
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --reduced --device cpu
  python -m repro_torch.launch.serve --arch zamba2-7b --reduced --device cpu
  python -m repro_torch.launch.serve --arch qwen2-vl-2b --reduced --device cpu
  python -m repro_torch.launch.serve --arch gemma2-2b        # on the card

Qwen2-VL decodes text-only prompts (its M-RoPE positions the same on all
three streams); HuBERT X-Large (``--arch hubert-xlarge``) is an encoder and
exits with "encoder-only: no decode path", as the reference's CLI does.

Entry points run on CUDA unless ``device="cpu"`` / ``--device cpu`` is
given (on a mesh: the mesh's device), and raise without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..configs import get_config, get_reduced
from ..device import resolve_device, synchronize
from ..models import Model, ModelConfig
from ..models.common import axis_rules, resolve_specs
from ..serving import scan_prefill
from .mesh import NodeMesh
from .sharding import PROFILES, ShardingProfile, cache_shard, cache_specs, param_shard, \
    profile_for_arch

__all__ = ["ServeJob", "make_serve_job", "main"]


def _rows(mesh: Optional[NodeMesh], batch: int) -> slice:
    """A data rank's rows of a batch of ``batch`` (see ``ServeJob.rows``)."""
    d_size, d = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    if batch % d_size:
        return slice(0, batch)
    n = batch // d_size
    return slice(d * n, (d + 1) * n)


@dataclasses.dataclass
class ServeJob:
    """The serve job: ``prefill_fn(params, batch, global_batch=None) ->
    (last logits, caches)`` and ``decode_fn(params, caches, tokens,
    position, global_batch=None) -> (logits, caches)`` in bf16 activations
    under ``torch.inference_mode()``.  On a mesh each takes this rank's
    parameter shards (:meth:`shard_params`), its data rank's rows
    (:meth:`local_batch`) and its cache shards (:meth:`init_cache`, or the
    prefill's), and returns the whole vocabulary's logits of those rows,
    the same bits on every rank of the model group.  ``global_batch``, the
    whole batch's row count, is required on more than one data rank: it
    says whether the rows are this data rank's block of the batch or all
    of it (:meth:`rows`), which a MoE's queues over the whole batch need,
    and the rows are checked against it.  ``param_layout`` is the
    parameters' spec tree under the profile's ``serve_param_rules`` (the
    reference's ``param_shardings``); ``mesh`` and ``param_layout`` are
    None for the one-device job."""

    model: Model
    device: torch.device
    param_dtype: torch.dtype
    prefill_fn: Callable
    decode_fn: Callable
    mesh: Optional[NodeMesh] = None
    profile: Optional[ShardingProfile] = None
    param_layout: Any = None

    def init_params(self, seed: int = 0):
        """Random whole parameters in ``param_dtype`` on the job's device
        (cut a rank's shard with :meth:`shard_params`)."""
        return self.model.init(seed, dtype=self.param_dtype, device=self.device)

    def shard_params(self, whole):
        """This rank's shard of a whole parameter tree (the one-device job:
        the tree itself)."""
        return param_shard(whole, self.param_layout, self.mesh)

    def rows(self, batch: int) -> slice:
        """This data rank's rows of a batch of ``batch``: its contiguous
        part where the data axis divides the batch, else all of them (every
        data rank serves the whole batch, as the reference's specs fall
        back)."""
        return _rows(self.mesh, batch)

    def local_batch(self, batch):
        """This data rank's rows (:meth:`rows`) of a batch: a tensor, or a
        dict of tensors with the batch leading, on the job's device."""
        if isinstance(batch, dict):
            return {k: self.local_batch(v) for k, v in batch.items()}
        t = torch.as_tensor(batch)
        return t[self.rows(t.shape[0])].to(self.device)

    def cache_layout(self, caches):
        """The spec tree of a whole cache tree (``cache_specs``: the batch
        over the data axis where it divides, the heads or channels over
        ``model`` where they divide) on the job's mesh."""
        if self.mesh is None:
            raise ValueError("the one-device job lays out no cache")
        return cache_specs(caches, self.profile.data_axes(self.mesh) or None, mesh=self.mesh)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """Empty decode caches of a batch of ``batch``: this rank's shard,
        cut from the whole tree as :meth:`cache_layout` lays it out."""
        whole = self.model.init_cache(batch, max_len, dtype=dtype, device=self.device)
        if self.mesh is None:
            return whole
        return cache_shard(whole, self.cache_layout(whole), self.mesh)


def make_serve_job(cfg: ModelConfig, mesh: Optional[NodeMesh] = None, *, profile=None,
                   device=None, param_dtype=torch.bfloat16) -> ServeJob:
    """The serve job of ``cfg``: one device (``mesh`` None), or a
    ``NodeMesh`` of D data ranks x a model axis of M (see the module
    docstring).  ``profile`` (a ``ShardingProfile`` or its name; None: the
    arch's default) gives the serve rules, which are the same for every
    profile.  ``device``: CUDA unless the CPU is asked for; on a mesh, the
    mesh's device."""
    if profile is None:
        profile = profile_for_arch(cfg.name)
    elif isinstance(profile, str):
        profile = PROFILES[profile]
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.device
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
        if mesh.data_group is not None:
            raise ValueError("the serve job splits its batch over the mesh's node-axis ranks; "
                             "a within-node data axis (NodeMesh(data=...)) is the '2d' "
                             "training layout")
    model = Model(cfg)
    tp = param_layout = None
    if mesh is not None:
        tp = mesh.model_group
        with axis_rules(profile.serve_rules(mesh), mesh,
                        param_rules=profile.serve_param_rules(mesh)):
            param_layout = resolve_specs(model.param_specs())

    def split_over(rows: int, global_batch: Optional[int]) -> Optional[NodeMesh]:
        """The mesh where ``rows`` are this data rank's block of a batch of
        ``global_batch`` split over the data ranks, else None."""
        if mesh is None or mesh.world == 1:
            return None
        if global_batch is None:
            raise ValueError(f"on {mesh.world} data ranks the job needs global_batch, the "
                             "whole batch's row count")
        part = _rows(mesh, int(global_batch))
        if part.stop - part.start != rows:
            raise ValueError(f"{rows} rows are not data rank {mesh.rank}'s {part} of a batch "
                             f"of {global_batch}")
        return mesh if rows != global_batch else None

    @torch.inference_mode()
    def prefill_fn(params, batch, global_batch=None):
        data = split_over(next(iter(batch.values())).shape[0], global_batch)
        return model.prefill(params, batch, dtype=torch.bfloat16, tp=tp, data=data)

    @torch.inference_mode()
    def decode_fn(params, caches, tokens, position, global_batch=None):
        data = split_over(tokens.shape[0], global_batch)
        return model.decode_step(params, caches, tokens, position, dtype=torch.bfloat16, tp=tp,
                                 data=data)

    return ServeJob(model=model, device=dev, param_dtype=param_dtype,
                    prefill_fn=prefill_fn, decode_fn=decode_fn, mesh=mesh, profile=profile,
                    param_layout=param_layout)


@torch.inference_mode()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma2-2b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new-tokens", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.head != "lm":
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    job = make_serve_job(cfg, device=args.device)
    model, dev = job.model, job.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    # as the reference's CLI: the job's mesh and profile, the compute unsharded
    print(f"[serve] {cfg.name} on {dev} ({name}), mesh {{'data': 1, 'model': 1}} "
          f"({job.profile.name} profile)")

    params = model.init(args.seed, dtype=torch.float32, device=dev)
    max_len = args.prompt_len + args.new_tokens
    caches = model.init_cache(args.requests, max_len, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.requests, args.prompt_len),
                            generator=gen, device=dev)

    synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = scan_prefill(model, params, caches, prompts, dtype=torch.float32)
    synchronize(dev)
    prefill_s = time.perf_counter() - t0
    print(f"[serve] prefill: {args.prompt_len} tokens x {args.requests} requests "
          f"in {prefill_s:.2f}s")

    def sample(logits):
        if args.temperature <= 0:
            return torch.argmax(logits[:, -1], dim=-1)
        probs = torch.softmax(logits[:, -1].float() / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    tok = sample(logits)[:, None]
    out = []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(args.new_tokens):
        out.append(tok[:, 0])
        pos = torch.full((args.requests,), args.prompt_len + i, dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(params, caches, tok, pos, dtype=torch.float32)
        tok = sample(logits)[:, None]
    synchronize(dev)
    decode_s = time.perf_counter() - t0
    gen_tokens = torch.stack(out, dim=1).cpu().numpy()
    tput = args.requests * args.new_tokens / decode_s
    print(f"[serve] decode: {args.new_tokens} tokens/request, "
          f"{decode_s / args.new_tokens * 1000:.1f} ms/step, {tput:.1f} tok/s aggregate")
    finite = bool(torch.isfinite(logits).all())
    if not finite:
        raise RuntimeError("non-finite logits")
    for b in range(min(args.requests, 4)):
        print(f"  req {b}: {gen_tokens[b][:12].tolist()} ...")
    print("[serve] OK")
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "decode_ms_per_step": decode_s / args.new_tokens * 1e3,
            "tokens_per_s": tput, "tokens": gen_tokens, "finite": finite}


if __name__ == "__main__":
    main()
