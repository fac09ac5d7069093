"""Architecture configs: the reference's ``repro.configs`` for the archs the
port's model stack runs, each with its full ``config()`` and its CPU-sized
``reduced()``.

The port has the dense and sliding-window attention blocks, which is all
Gemma-2 2B, Yi-9B, Minitron-8B and Command R+ use, the RWKV-6 block of
RWKV-6 3B, the mixture-of-experts block of Qwen1.5-MoE-A2.7B and Arctic
480B, and the Mamba-2 and shared attention blocks of Zamba2-7B.  The two
other archs raise ``NotImplementedError`` naming the ROADMAP item they
wait for.
"""
from importlib import import_module

ARCH_IDS = [
    "arctic_480b",
    "qwen2_moe_a2_7b",
    "zamba2_7b",
    "qwen2_vl_2b",
    "gemma2_2b",
    "yi_9b",
    "command_r_plus_104b",
    "rwkv6_3b",
    "hubert_xlarge",
    "minitron_8b",
]
PORTED = ("gemma2_2b", "yi_9b", "minitron_8b", "command_r_plus_104b", "rwkv6_3b",
          "qwen2_moe_a2_7b", "arctic_480b", "zamba2_7b")
WAITING = {
    "qwen2_vl_2b": "M-RoPE and the vision front end (ROADMAP queue 1 item 7 (d))",
    "hubert_xlarge": "the HuBERT audio encoder (ROADMAP queue 1 item 7 (d))",
}

# canonical dashed ids used on the CLI
CLI_IDS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _mod(arch: str):
    arch = CLI_IDS.get(arch, arch).replace("-", "_").replace(".", "_")
    arch = arch.replace("_reduced", "")
    if arch in WAITING:
        raise NotImplementedError(f"{arch} waits for {WAITING[arch]}")
    if arch not in PORTED:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _mod(arch).config()


def get_reduced(arch: str):
    return _mod(arch).reduced()
