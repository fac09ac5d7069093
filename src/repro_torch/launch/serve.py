"""The LM serving path on one device: the serve job and the serving CLI.

Counterpart of the serving part of ``repro.launch.distributed``
(``ServeJob``, ``make_serve_job``) and of ``repro.launch.serve``, on one
device with no mesh.  ``make_serve_job(cfg).prefill_fn`` runs
``Model.prefill`` in bf16 -- with ``attn_impl="pallas"`` every attention
layer (a MoE block's and Zamba2's shared block's too) goes through the
hand-written flash-attention kernel, and with ``replace(cfg, rwkv_chunk=16,
rwkv_pallas=True)`` every RWKV-6 layer's time-mix through the hand-written
wkv_chunk kernel -- and ``decode_fn`` runs ``Model.decode_step`` in bf16
against the decode caches (ring buffers for attention, the recurrent
states for RWKV-6 and Mamba-2).  Both run
under ``torch.inference_mode()``.

The CLI does what the reference's does: fp32 parameters from the seed and
fp32 caches, the prompts prefilled through ``scan_prefill`` (decode steps),
then ``--new-tokens`` of greedy (or sampled) decode:

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
given, and raise without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import torch

from ..configs import get_config, get_reduced
from ..device import resolve_device, synchronize
from ..models import Model, ModelConfig
from ..serving import scan_prefill

__all__ = ["ServeJob", "make_serve_job", "main"]


@dataclasses.dataclass
class ServeJob:
    model: Model
    device: torch.device
    param_dtype: torch.dtype
    prefill_fn: Callable      # (params, batch) -> (last logits, caches)
    decode_fn: Callable       # (params, caches, tokens, position) -> (logits, caches)

    def init_params(self, seed: int = 0):
        """Random parameters in ``param_dtype`` on the job's device."""
        return self.model.init(seed, dtype=self.param_dtype, device=self.device)


def make_serve_job(cfg: ModelConfig, *, device=None, param_dtype=torch.bfloat16) -> ServeJob:
    dev = resolve_device(device)
    model = Model(cfg)

    @torch.inference_mode()
    def prefill_fn(params, batch):
        return model.prefill(params, batch, dtype=torch.bfloat16)

    @torch.inference_mode()
    def decode_fn(params, caches, tokens, position):
        return model.decode_step(params, caches, tokens, position, dtype=torch.bfloat16)

    return ServeJob(model=model, device=dev, param_dtype=param_dtype,
                    prefill_fn=prefill_fn, decode_fn=decode_fn)


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
    print(f"[serve] {cfg.name} on {dev} ({name})")

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
