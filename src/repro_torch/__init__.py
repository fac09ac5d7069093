"""PyTorch port of the DSE-MVR / DSE-SGD system, for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``, with the same
module layout.  It imports torch, numpy and the standard library only --
never JAX or ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.  On the card each kernel op launches a hand-written
kernel (``repro_torch.kernels``); on the CPU its plain PyTorch version
runs:

  * Triton: the update arithmetic (``mvr_update``, ``axpby``, ``add_sub``,
    ``dse_combine``, ``dse_combine_yh``) and the QSGD codec
    (``qsgd_quantize``, ``qsgd_dequantize``);
  * CUDA C++ (``repro_torch/csrc``): the top-k payload (``top_k_pack``,
    ``top_k_unpack``), ``flash_attention``, ``wkv_chunk`` and
    ``rms_norm``.

Ported so far:

  * DSE-MVR / DSE-SGD and the six baselines through the round executor in
    the single-host Simulator on the ring(8) pseudo-MNIST MLP
    (``repro_torch.paper_problem.run_method``), with compressed gossip on
    the dense engine: the qsgd, top_k, rand_k and low_rank codecs on the
    sync, choco and async channels, per-buffer channels and overlap;
  * the scenario engine (``repro_torch.scenarios``): time-varying mixing,
    dropout, stragglers, client jitter and per-round codec knobs;
  * the telemetry hub (``repro_torch.telemetry``) and checkpoints in the
    reference's on-disk format (``repro_torch.checkpoint``);
  * the LM serving path (``repro_torch.models``, ``configs``, ``serving``,
    ``launch.serve``) for the dense and sliding-window attention archs
    (Gemma-2 2B, Yi-9B, Minitron-8B, Command R+), RWKV-6 3B (its time-mix
    through ``wkv_chunk``), the mixture-of-experts archs (Qwen1.5-MoE-A2.7B,
    Arctic 480B), the Mamba-2 hybrid Zamba2-7B and Qwen2-VL-2B (M-RoPE,
    the vision front end): prefill through the flash-attention kernel,
    decode against the caches, continuous batching; and the HuBERT X-Large
    audio encoder with its frame head;
  * LM training through ``Model.loss``: every kernel op is differentiable,
    its backward the plain version's gradient (``kernels/api.py``).
"""
