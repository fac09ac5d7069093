#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for matmul and cuDNN;
2. kernels: each Triton kernel of the DSE path (mvr_update, axpby,
   dse_combine, dse_combine_yh), built from the checkout on first launch,
   is held against its plain PyTorch version on the card -- on the 8-node
   MLP tree the main path feeds it and on one flat buffer of 2**26+3
   elements in fp32 and bf16 -- and timed with CUDA events on the fp32
   buffer beside its HBM bound, its plain version and a one-call PyTorch
   yardstick where one exists;
3. main path: ``run_method("dse_mvr", omega=0.5, tau=4, b=16, steps=200)`` at
   the MLP's full width through the kernels, against the unfused path on
   the card and on the CPU from the same index stream; then the fused-z
   state layout and DSE-SGD.  Launch counts are reset just before and read
   just after each run through the kernels;
4. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS, TAU, BATCH, OMEGA = 200, 4, 16, 0.5
BIG_N = 2**26 + 3
REPS = 25
# fp32 kernel vs plain: FMA contraction in the kernel may move one ulp
RTOL32 = ATOL32 = 1e-6
# run vs run (kernels vs plain on the card vs plain on the CPU): fp32
# reassociation (cuBLAS vs CPU GEMM, FMA) drifts over 200 steps
RUN_RTOL, RUN_ATOL, ACC_TOL = 5e-4, 1e-5, 2e-3
FP32_PEAK_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores

# op -> (kernel source, TPU kernel replaced, scalars, flops per element)
OPS = {
    "mvr_update": ("src/repro_torch/kernels/mvr_update/kernel.py",
                   "src/repro/kernels/mvr_update/kernel.py:21", (0.05,), 3),
    "axpby": ("src/repro_torch/kernels/tree_math/kernel.py",
              "src/repro/kernels/tree_math/kernel.py:16", (-0.3, 1.0), 3),
    "dse_combine": ("src/repro_torch/kernels/dse_combine/kernel.py",
                    "src/repro/kernels/dse_combine/kernel.py:25", (0.3,), 4),
    "dse_combine_yh": ("src/repro_torch/kernels/dse_combine/kernel.py",
                       "src/repro/kernels/dse_combine/kernel.py:31", (0.3,), 5),
}


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM bandwidth of the card by product name."""
    if "H200" in name:
        return 4.8e12
    if "NVL" in name:
        return 3.9e12
    if "PCIe" in name:
        return 2.0e12
    return 3.35e12


def spin_up(seconds: float = 1.0) -> None:
    """Keep the card busy for a while so its clocks are up before timing."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def cuda_times(fn) -> list:
    """Per-call device times of ``fn`` (ms), REPS calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def abba_ms(*fns) -> list:
    """Median ms of each function, timed in turns (a, b, ..., ..., b, a)."""
    samples = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        samples[i] += cuda_times(fns[i])
    return [statistics.median(x) for x in samples]


def bf16_excess_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| beyond the fp32 tolerance, in bf16 ulps of the
    larger magnitude.  Both sides compute in fp32 and round once to bf16, so
    they differ by one rounding step plus their fp32 difference; where an
    output cancels to near zero that fp32 difference (an ulp of the O(1)
    operands) is many bf16 ulps of the output, so it is taken off first."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), exp - 8)   # bf16: 8 significand bits
    return float(((g - w).abs() - ATOL32).clamp(min=0).div(ulp).max())


def main() -> int:
    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import api
    from repro_torch.paper_problem import make_paper_problem, run_method

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    kind = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"HBM bound at {bw / 1e12} TB/s; host CPU path "
          f"{torch.backends.cpu.get_cpu_capability()} x{torch.get_num_threads()}")

    # ---------------------------------------------------------------- 2
    spin_up()
    gen = torch.Generator().manual_seed(0)

    def rand_tree(shapes, dtype):
        return {k: torch.randn(s, generator=gen).to("cuda", dtype) for k, s in shapes.items()}

    mlp_shapes = {"w1": (8, 196, 64), "b1": (8, 64), "w2": (8, 64, 10), "b2": (8, 10)}
    results = {}
    for name, (source, replaces, scalars, flops) in OPS.items():
        op = api.get(name)
        row = {"name": name, "route": "triton", "source": source, "replaces": replaces}
        max_err = 0.0
        for label, shapes, dtype in (
            ("mlp", mlp_shapes, torch.float32),
            ("big", {"x": (BIG_N,)}, torch.float32),
            ("big_bf16", {"x": (BIG_N,)}, torch.bfloat16),
        ):
            trees = [rand_tree(shapes, dtype) for _ in range(op.n_inputs)]
            got = api.tree_apply(name, *trees, scalars=scalars)
            with api.dispatch_mode("ref"):
                want = api.tree_apply(name, *trees, scalars=scalars)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g_tree, w_tree in zip(got, want):
                for k in shapes:
                    g, w = g_tree[k], w_tree[k]
                    assert g.dtype == w.dtype == dtype, (name, label, g.dtype, w.dtype)
                    if dtype == torch.bfloat16:
                        ulps = bf16_excess_ulps(g, w)
                        assert ulps <= 1.0, f"{name} {label}: {ulps} bf16 ulps"
                        row["bf16_max_abs_err"] = max(
                            row.get("bf16_max_abs_err", 0.0), float((g - w).abs().max()))
                    else:
                        torch.testing.assert_close(g, w, rtol=RTOL32, atol=ATOL32)
                        max_err = max(max_err, float((g - w).abs().max()))

            def kernel():
                api.tree_apply(name, *trees, scalars=scalars)

            def plain():
                with api.dispatch_mode("ref"):
                    api.tree_apply(name, *trees, scalars=scalars)

            if label == "mlp":
                row["mlp_ms"], row["mlp_plain_ms"] = abba_ms(kernel, plain)
            if label == "big":
                elem = trees[0]["x"].element_size()
                n_bytes = (op.n_inputs + op.n_outputs) * BIG_N * elem
                bytes_ms = n_bytes / bw * 1e3
                ops_ms = flops * BIG_N / FP32_PEAK_FLOPS * 1e3
                row["bound_ms"] = max(bytes_ms, ops_ms)
                row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
                fns = [kernel, plain]
                if name == "axpby":   # b = 1 on the DSE path: y + a*x is one call
                    x, y = trees[0]["x"], trees[1]["x"]
                    out = torch.empty_like(y)
                    fns.append(lambda: torch.add(y, x, alpha=scalars[0], out=out))
                times = abba_ms(*fns)
                row["ms"], row["plain_ms"] = times[:2]
                row["library_ms"] = times[2] if len(times) > 2 else None
            del trees, got, want
        row["max_abs_err"] = max_err
        results[name] = row
        print(f"kernel {name}: max_abs_err={max_err:.3g} "
              f"bf16_max_abs_err={row.get('bf16_max_abs_err')} ms={row['ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']} mlp_ms={row['mlp_ms']:.4f} "
              f"mlp_plain_ms={row['mlp_plain_ms']:.4f}")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3
    data, _ = make_paper_problem(OMEGA, seed=0)
    idx_cpu = torch.randint(
        0, data.samples_per_node, (STEPS, data.n_nodes, BATCH),
        generator=torch.Generator().manual_seed(1234),
    )
    idx_cuda = idx_cpu.cuda()

    def run(name, device, **kw):
        idx = idx_cuda if device == "cuda" else idx_cpu
        api.reset_counters()
        out = run_method(name, OMEGA, TAU, BATCH, STEPS, device=device,
                         index_fn=lambda s: idx[s], **kw)
        out["launches"] = api.launch_counts()
        out["steps_per_s"] = STEPS / out["wall_s"]
        print(f"run {name} device={device} {kw}: " + json.dumps(out))
        return out

    def agree(a, b, what):
        for k in ("train_loss", "consensus"):
            ok = abs(a[k] - b[k]) <= RUN_ATOL + RUN_RTOL * abs(b[k])
            assert ok, f"{what}: {k} {a[k]} vs {b[k]}"
        assert abs(a["test_acc"] - b["test_acc"]) <= ACC_TOL, f"{what}: test_acc"
        for k in ("train_loss", "consensus", "test_acc"):
            assert a[k] == a[k] and abs(a[k]) < float("inf"), f"{what}: {k} not finite"

    # a short run on each path first keeps one-time set-up (cuBLAS handles,
    # autograd's worker threads) out of the timed runs
    for use_fused in (True, False):
        run_method("dse_mvr", OMEGA, TAU, BATCH, 8, device="cuda",
                   use_fused=use_fused, index_fn=lambda s: idx_cuda[s])
    fused = run("dse_mvr", "cuda", use_fused=True)
    plain_cuda = run("dse_mvr", "cuda", use_fused=False)
    plain_cpu = run("dse_mvr", "cpu", use_fused=False)
    assert not plain_cuda["launches"] and not plain_cpu["launches"]
    # the second half of a kernels, plain, plain, kernels turn for steps/s
    plain_cuda_2 = run("dse_mvr", "cuda", use_fused=False)
    fused_2 = run("dse_mvr", "cuda", use_fused=True)
    print("dse_mvr steps/s in turns: kernels %.1f %.1f, plain %.1f %.1f" % (
        fused["steps_per_s"], fused_2["steps_per_s"],
        plain_cuda["steps_per_s"], plain_cuda_2["steps_per_s"]))
    agree(fused_2, fused, "dse_mvr kernels, run to run")
    agree(plain_cuda_2, plain_cuda, "dse_mvr plain cuda, run to run")
    agree(fused, plain_cpu, "dse_mvr kernels vs cpu")
    agree(plain_cuda, plain_cpu, "dse_mvr plain cuda vs cpu")
    agree(fused, plain_cuda, "dse_mvr kernels vs plain cuda")
    for op in ("mvr_update", "axpby", "dse_combine_yh"):
        assert fused["launches"].get(op, 0) > 0, f"dse_mvr did not launch {op}"

    fused_z = run("dse_mvr", "cuda", use_fused=True, fuse_tracking_buffers=True)
    agree(fused_z, run("dse_mvr", "cpu", fuse_tracking_buffers=True), "fused-z")
    assert fused_z["launches"].get("dse_combine", 0) > 0, "fused-z did not launch dse_combine"

    sgd = run("dse_sgd", "cuda", use_fused=True)
    agree(sgd, run("dse_sgd", "cpu"), "dse_sgd")
    for op in ("axpby", "dse_combine_yh"):
        assert sgd["launches"].get(op, 0) > 0, f"dse_sgd did not launch {op}"

    # ---------------------------------------------------------------- 4
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_max_abs_err",
            "mlp_ms", "mlp_plain_ms")
    kernels = []
    for name, row in results.items():
        row["launches"] = sum(r["launches"].get(name, 0) for r in (fused, fused_z, sgd))
        assert row["launches"] > 0, f"{name} never launched on the main path"
        kernels.append({k: row.get(k) for k in keys})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
