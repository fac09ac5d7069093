"""PyTorch port of the DSE-MVR / DSE-SGD system, for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``, with the same
module layout.  It imports torch, numpy and the standard library only --
never JAX or ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; the update arithmetic's kernels are hand-written Triton
(``repro_torch.kernels``), and on the CPU their plain PyTorch versions run.

Ported so far: the paper's main path -- DSE-MVR / DSE-SGD through the round
executor in the single-host Simulator on the ring(8) pseudo-MNIST MLP
(``repro_torch.paper_problem.run_method``).
"""
