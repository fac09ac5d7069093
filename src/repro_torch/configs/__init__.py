"""Architecture configs: the reference's ``repro.configs`` for the archs the
port's model stack runs, each with its full ``config()`` and its CPU-sized
``reduced()``.

The port runs every arch of the reference: the dense and sliding-window
attention blocks (Gemma-2 2B, Yi-9B, Minitron-8B, Command R+), the RWKV-6
block (RWKV-6 3B), the mixture-of-experts block (Qwen1.5-MoE-A2.7B, Arctic
480B), the Mamba-2 and shared attention blocks (Zamba2-7B), M-RoPE and the
vision front end (Qwen2-VL-2B) and the bidirectional audio encoder with
its frame head (HuBERT X-Large).
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

# canonical dashed ids used on the CLI
CLI_IDS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _mod(arch: str):
    """The config module of ``arch``: ``repro_torch.configs.<arch>``, imported
    as the reference imports its own, so that a module registered in
    ``sys.modules`` under that name is found (an unknown arch raises
    ``ModuleNotFoundError``)."""
    arch = CLI_IDS.get(arch, arch).replace("-", "_").replace(".", "_")
    arch = arch.replace("_reduced", "")
    return import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _mod(arch).config()


def get_reduced(arch: str):
    return _mod(arch).reduced()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
