"""PyTorch port of the DSE-MVR / DSE-SGD system, for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``, with the same
module layout.  It imports torch, numpy and the standard library only --
never JAX or ``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``; the update arithmetic's and the QSGD codec's kernels are
hand-written Triton (``repro_torch.kernels``), and on the CPU their plain
PyTorch versions run.

Ported so far: DSE-MVR / DSE-SGD and the six baselines through the round
executor in the single-host Simulator on the ring(8) pseudo-MNIST MLP
(``repro_torch.paper_problem.run_method``), with optional QSGD-compressed
synchronous gossip under error feedback (``compression="qsgd"``).
"""
