"""Serving example on the PyTorch port: batched prefill + autoregressive
decode with KV caches.

The counterpart of ``examples/serve.py`` on ``repro_torch``: builds a
reduced config on random weights from a seed, prefills a batch of prompts
by decode steps (``scan_prefill``) and greedily decodes continuations.

  PYTHONPATH=src python examples/serve_torch.py --arch gemma2-2b --tokens 32      # on CUDA
  PYTHONPATH=src python examples/serve_torch.py --device cpu --tokens 4
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import Model
from repro_torch.serving import scan_prefill


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma2-2b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--tokens", type=int, default=32)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch)
    model = Model(cfg)
    params = model.init(0, dtype=torch.float32, device=dev)
    print(f"[serve] {cfg.name} on {dev}: {args.batch} requests, prompt {args.prompt_len}, "
          f"decoding {args.tokens} tokens")

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=dev)
    max_len = args.prompt_len + args.tokens

    # prefill by replaying prompt tokens through the decode path (every arch
    # family alike: attention caches, SSM states, RWKV states)
    caches = model.init_cache(args.batch, max_len, dtype=torch.float32, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = scan_prefill(model, params, caches, prompts, dtype=torch.float32)
    synchronize(dev)
    prefill_s = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(args.tokens):
            out_tokens.append(tok[:, 0])
            pos = torch.full((args.batch,), args.prompt_len + i, dtype=torch.int32, device=dev)
            logits, caches = model.decode_step(params, caches, tok, pos, dtype=torch.float32)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    synchronize(dev)
    decode_s = time.perf_counter() - t0

    gen_tokens = torch.stack(out_tokens, dim=1).cpu().numpy()
    print(f"[serve] prefill {prefill_s * 1000:.0f} ms, "
          f"decode {decode_s / args.tokens * 1000:.1f} ms/token")
    for b in range(args.batch):
        print(f"  request {b}: {gen_tokens[b][:16].tolist()} ...")
    assert bool(torch.isfinite(logits).all())
    print("[serve] OK")
    return gen_tokens


if __name__ == "__main__":
    main()
