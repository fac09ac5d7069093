"""End-to-end driver on the PyTorch port: decentralized DSE-MVR training of
a transformer LM (``repro_torch``; the JAX original is
``examples/decentralized_lm.py``).

The default trains a ~20M-parameter llama-family model for 200 rounds;
``--full`` selects the ~100M model (12 layers, d 768, 12 heads on 4 KV
heads, d_ff 2048, vocab 16,384, tied).  It runs on the card unless
``--device cpu``:

  PYTHONPATH=src python examples/decentralized_lm_torch.py --full --steps 300
  PYTHONPATH=src python examples/decentralized_lm_torch.py --device cpu --steps 2

The config is registered as a module ``repro_torch.configs.<name>`` and the
run goes through the training CLI (``repro_torch.launch.train``), as a user
would register a config of their own.
"""
import argparse
import sys

from repro_torch.launch import train as train_cli
from repro_torch.models import ModelConfig


def lm_20m():
    return ModelConfig(
        name="lm-20m", arch_type="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192,
        block_unit=("attn",), tie_embeddings=True,
    )


def lm_100m():
    return ModelConfig(
        name="lm-100m", arch_type="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=16384,
        block_unit=("attn",), tie_embeddings=True,
    )


def register(cfg: ModelConfig) -> str:
    """Make ``cfg`` a config module the registry finds; returns its name."""
    mod_name = cfg.name.replace("-", "_")
    module = type(sys)(f"repro_torch.configs.{mod_name}")
    module.config = lambda: cfg
    module.reduced = lambda: cfg
    sys.modules[f"repro_torch.configs.{mod_name}"] = module
    return cfg.name


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true", help="~100M params")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--tau", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.1,
                   help="the reference example's 0.1 by default; lm-100m diverges "
                        "there in both packages")
    p.add_argument("--out", default="/tmp/decentralized_lm_torch")
    p.add_argument("--device", default=None, help="the card (the default) or 'cpu'")
    p.add_argument("--use-fused", action="store_true",
                   help="route the update arithmetic through the kernels")
    args = p.parse_args(argv)

    arch = register(lm_100m() if args.full else lm_20m())
    cli = [
        "--arch", arch, "--steps", str(args.steps), "--tau", str(args.tau),
        "--seq-len", "128", "--global-batch", "8", "--lr", str(args.lr),
        "--algorithm", "dse_mvr", "--out", args.out, "--ckpt-every", "50",
    ]
    if args.device:
        cli += ["--device", args.device]
    if args.use_fused:
        cli.append("--use-fused")
    return train_cli.main(cli)


if __name__ == "__main__":
    main()
