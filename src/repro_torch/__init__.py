"""PyTorch port of the DSE-MVR / DSE-SGD system, for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``, with the same
module layout.  It imports torch, numpy and the standard library only --
never JAX or ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; the update arithmetic's, the QSGD codec's and the RMSNorm
kernels are hand-written Triton, the top-k payload's and flash attention's
hand-written CUDA C++ (``repro_torch.kernels``), and on the CPU their plain
PyTorch versions run.

Ported so far: DSE-MVR / DSE-SGD and the six baselines through the round
executor in the single-host Simulator on the ring(8) pseudo-MNIST MLP
(``repro_torch.paper_problem.run_method``), with optional compressed gossip
on the dense engine: the qsgd, top_k, rand_k and low_rank codecs on the
sync, choco and async channels, per-buffer channels and overlap.  And the
LM serving path for the dense and sliding-window attention archs
(``repro_torch.models``, ``configs``, ``serving``, ``launch.serve``):
prefill through the flash-attention kernel, decode against ring-buffer
caches, continuous batching.
"""
