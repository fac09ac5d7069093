#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for matmul and cuDNN;
2. kernels: each of the seven Triton kernels (mvr_update, axpby, add_sub,
   dse_combine, dse_combine_yh, qsgd_quantize, qsgd_dequantize), built from
   the checkout on first launch, is held against its plain PyTorch version
   on the card -- on the 8-node MLP tree as the main path feeds it and on
   one flat buffer of 2**26+3 elements in fp32 and bf16 -- and timed with
   CUDA events on the fp32 buffer beside its HBM bound, its plain version
   and a one-call PyTorch yardstick where one exists;
3. main paths, each through ``run_method`` at the MLP's full width:
   DSE-MVR (omega=0.5, tau=4, b=16, 200 steps) through the kernels against
   the unfused path on the card and on the CPU from the same index stream,
   then the fused-z state layout and DSE-SGD; the six baselines through the
   kernels against the CPU; DSE-MVR with QSGD-compressed gossip through the
   kernels, plain on the card and plain on the CPU from the same index and
   codec-seed streams (64 steps); and ``compression="identity"`` against the
   uncompressed run.  Launch counts are reset just before and read just
   after each run through the kernels;
4. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import importlib.metadata
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS, TAU, BATCH, OMEGA = 200, 4, 16, 0.5
QSGD_STEPS = 64
BIG_N = 2**26 + 3
REPS = 25
# fp32 kernel vs plain: FMA contraction in the kernel may move one ulp
RTOL32 = ATOL32 = 1e-6
# qsgd_quantize vs plain: at most this share of levels may differ, by one
FLIP_BUDGET = 1e-4
# run vs run (kernels vs plain on the card vs plain on the CPU): fp32
# reassociation (cuBLAS vs CPU GEMM, FMA) drifts over 200 steps
RUN_RTOL, RUN_ATOL, ACC_TOL = 5e-4, 1e-5, 2e-3
# compressed runs, held over QSGD_STEPS: an ulp that moves |x|*L + u across
# an integer flips one int8 level, error feedback carries it and later
# steps compound it.  On the CPU the port lies 1e-3 from the reference after
# 64 steps (tests/test_torch_compression.py)
QSGD_RTOL, QSGD_ACC_TOL = 5e-3, 5e-3
FP32_PEAK_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
BASELINES = ("dlsgd", "dsgd", "gt_dsgd", "gt_hsgd", "pd_sgdm", "slowmo_d")
MLP_SHAPES = {"w1": (8, 196, 64), "b1": (8, 64), "w2": (8, 64, 10), "b2": (8, 10)}


def randn(shape, dtype, gen, feed):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def unit(shape, dtype, gen, feed):
    """A node-normalized buffer, |x| <= 1 (the quantize's input)."""
    return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(dtype)


def uniform01(shape, dtype, gen, feed):
    """The quantize's U[0, 1) noise."""
    return torch.rand(shape, generator=gen, device="cuda").to(dtype)


def levels(shape, dtype, gen, feed):
    """The int8 QSGD payload, whatever the float dtype."""
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def scale_of(shape, dtype, gen, feed):
    """A positive per-node scale.  On the MLP tree it is the (N, 1) scale
    broadcast as the codec passes it (a stride-0 view that ``tree_apply``
    copies); on the flat buffer a full buffer."""
    if feed == "mlp":
        s = torch.rand((shape[0], 1), generator=gen, device="cuda") * 1.9 + 0.1
        return s.to(dtype).expand(shape[0], math.prod(shape[1:])).reshape(shape)
    return (torch.rand(shape, generator=gen, device="cuda") * 1.9 + 0.1).to(dtype)


# op -> (kernel source, TPU kernel replaced, scalars, operations per element,
#        input makers)
OPS = {
    "mvr_update": ("src/repro_torch/kernels/mvr_update/kernel.py",
                   "src/repro/kernels/mvr_update/kernel.py:21", (0.05,), 3, (randn,) * 3),
    "axpby": ("src/repro_torch/kernels/tree_math/kernel.py",
              "src/repro/kernels/tree_math/kernel.py:16", (-0.3, 1.0), 3, (randn,) * 2),
    "add_sub": ("src/repro_torch/kernels/tree_math/kernel.py",
                "src/repro/kernels/tree_math/kernel.py:21", (), 2, (randn,) * 3),
    "dse_combine": ("src/repro_torch/kernels/dse_combine/kernel.py",
                    "src/repro/kernels/dse_combine/kernel.py:25", (0.3,), 4, (randn,) * 4),
    "dse_combine_yh": ("src/repro_torch/kernels/dse_combine/kernel.py",
                       "src/repro/kernels/dse_combine/kernel.py:31", (0.3,), 5, (randn,) * 5),
    "qsgd_quantize": ("src/repro_torch/kernels/comm_compress/kernel.py",
                      "src/repro/kernels/comm_compress/kernel.py:35", (127.0,), 5,
                      (unit, uniform01)),
    "qsgd_dequantize": ("src/repro_torch/kernels/comm_compress/kernel.py",
                        "src/repro/kernels/comm_compress/kernel.py:42", (1.0 / 127,), 2,
                        (levels, scale_of)),
}
# the QSGD codec calls its ops once per leaf (not once per dtype bucket)
PER_LEAF = ("qsgd_quantize", "qsgd_dequantize")


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
    from repro_torch.compression import link_bytes_per_round
    from repro_torch.core.simulate import default_comm_seed_fn
    from repro_torch.kernels import api
    from repro_torch.paper_problem import make_algorithm, make_paper_problem, mlp_init, run_method

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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {importlib.metadata.version('triton')} on {kind}; "
          f"HBM bound at {bw / 1e12} TB/s; host CPU path "
          f"{torch.backends.cpu.get_cpu_capability()} x{torch.get_num_threads()}")

    # ---------------------------------------------------------------- 2
    spin_up()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, (source, replaces, scalars, flops, makers) in OPS.items():
        op = api.get(name)
        row = {"name": name, "route": "triton", "source": source, "replaces": replaces}
        max_err, flips = 0.0, 0
        for label, shapes, dtype in (
            ("mlp", MLP_SHAPES, torch.float32),
            ("big", {"x": (BIG_N,)}, torch.float32),
            ("big_bf16", {"x": (BIG_N,)}, torch.bfloat16),
        ):
            trees = [{k: make(s, dtype, gen, label) for k, s in shapes.items()} for make in makers]

            def apply(mode="kernel"):
                with api.dispatch_mode(mode):
                    if name in PER_LEAF:
                        return ({k: api.call(name, *(t[k] for t in trees), scalars=scalars)
                                 for k in shapes},)
                    out = api.tree_apply(name, *trees, scalars=scalars)
                    return out if isinstance(out, tuple) else (out,)

            got, want = apply(), apply("ref")
            torch.cuda.synchronize()
            for g_tree, w_tree in zip(got, want):
                for k in shapes:
                    g, w = g_tree[k], w_tree[k]
                    assert g.dtype == w.dtype == dtype, (name, label, g.dtype, w.dtype)
                    if name == "qsgd_quantize":   # integer levels: count the flips
                        off = (g.float() - w.float()).abs()
                        n_off = int((off > 0).sum())
                        assert float(off.max()) <= 1.0, f"{name} {label}: a level off by >1"
                        assert n_off <= FLIP_BUDGET * off.numel(), f"{name} {label}: {n_off} flips"
                        flips += n_off
                        max_err = max(max_err, float(off.max()))
                    elif dtype == torch.bfloat16:
                        ulps = bf16_excess_ulps(g, w)
                        assert ulps <= 1.0, f"{name} {label}: {ulps} bf16 ulps"
                        row["bf16_max_abs_err"] = max(
                            row.get("bf16_max_abs_err", 0.0), float((g - w).abs().max()))
                    else:
                        torch.testing.assert_close(g, w, rtol=RTOL32, atol=ATOL32)
                        max_err = max(max_err, float((g - w).abs().max()))

            def plain():
                return apply("ref")

            if label == "mlp":
                row["mlp_ms"], row["mlp_plain_ms"] = abba_ms(apply, plain)
            if label == "big":
                n_bytes = sum(t["x"].numel() * t["x"].element_size() for t in trees + list(got))
                bytes_ms = n_bytes / bw * 1e3
                ops_ms = flops * BIG_N / FP32_PEAK_FLOPS * 1e3
                row["bound_ms"] = max(bytes_ms, ops_ms)
                row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
                fns = [apply, plain]
                if name == "axpby":   # b = 1 on the DSE path: y + a*x is one call
                    x, y = trees[0]["x"], trees[1]["x"]
                    out = torch.empty_like(y)
                    fns.append(lambda: torch.add(y, x, alpha=scalars[0], out=out))
                times = abba_ms(*fns)
                row["ms"], row["plain_ms"] = times[:2]
                row["library_ms"] = times[2] if len(times) > 2 else None
            del trees, got, want
        row["max_abs_err"] = max_err
        if name == "qsgd_quantize":
            row["flips"] = flips
        results[name] = row
        print(f"kernel {name}: max_abs_err={max_err:.3g} "
              f"bf16_max_abs_err={row.get('bf16_max_abs_err')} flips={row.get('flips')} "
              f"ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']} "
              f"mlp_ms={row['mlp_ms']:.4f} mlp_plain_ms={row['mlp_plain_ms']:.4f}")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3
    data, _ = make_paper_problem(OMEGA, seed=0)
    idx_cpu = torch.randint(
        0, data.samples_per_node, (STEPS, data.n_nodes, BATCH),
        generator=torch.Generator().manual_seed(1234),
    )
    idx_cuda = idx_cpu.cuda()
    seed_fn = default_comm_seed_fn(4321)   # the codec seeds, the same for every run
    kernel_runs = []                       # the runs through the kernels

    def run(name, device, steps=STEPS, mode="kernel", **kw):
        idx = idx_cuda if device == "cuda" else idx_cpu
        api.reset_counters()
        with api.dispatch_mode(mode):
            out = run_method(name, OMEGA, TAU, BATCH, steps, device=device,
                             index_fn=lambda s: idx[s], comm_seed_fn=seed_fn, **kw)
        out["launches"] = api.launch_counts()
        out["steps_per_s"] = steps / out["wall_s"]
        print(f"run {name} device={device} mode={mode} steps={steps} {kw}: " + json.dumps(out))
        if out["launches"]:
            kernel_runs.append(out)
        return out

    def agree(a, b, what, rtol=RUN_RTOL, acc_tol=ACC_TOL):
        for k in ("train_loss", "consensus"):
            ok = abs(a[k] - b[k]) <= RUN_ATOL + rtol * abs(b[k])
            assert ok, f"{what}: {k} {a[k]} vs {b[k]}"
        assert abs(a["test_acc"] - b["test_acc"]) <= acc_tol, f"{what}: test_acc"
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

    # the paper's baselines, through the kernels against the CPU
    baseline_rate = {}
    for name in BASELINES:
        got = run(name, "cuda", use_fused=True)
        agree(got, run(name, "cpu"), f"{name} kernels vs cpu")
        assert got["launches"].get("axpby", 0) > 0, f"{name} did not launch axpby"
        if name in ("gt_dsgd", "gt_hsgd"):
            assert got["launches"].get("add_sub", 0) > 0, f"{name} did not launch add_sub"
        if name == "gt_hsgd":   # one axpby, mvr_update and add_sub per step
            want = {"axpby": STEPS, "mvr_update": STEPS, "add_sub": STEPS}
            assert got["launches"] == want, got["launches"]
        baseline_rate[name] = got["steps_per_s"]
    print("baselines steps/s through the kernels: " + json.dumps(baseline_rate))

    # QSGD-compressed gossip: kernels, plain on the card, plain on the CPU
    q_kernels = run("dse_mvr", "cuda", steps=QSGD_STEPS, use_fused=True, compression="qsgd")
    q_plain_cuda = run("dse_mvr", "cuda", steps=QSGD_STEPS, mode="ref", compression="qsgd")
    q_plain_cpu = run("dse_mvr", "cpu", steps=QSGD_STEPS, compression="qsgd")
    events = QSGD_STEPS // TAU   # 4 leaves x 2 buffers per communication event
    assert q_kernels["launches"]["qsgd_quantize"] == 8 * events, q_kernels["launches"]
    assert q_kernels["launches"]["qsgd_dequantize"] == 8 * events, q_kernels["launches"]
    assert not q_plain_cuda["launches"] and not q_plain_cpu["launches"]
    for a, b, what in ((q_kernels, q_plain_cpu, "kernels vs cpu"),
                       (q_plain_cuda, q_plain_cpu, "plain cuda vs cpu"),
                       (q_kernels, q_plain_cuda, "kernels vs plain cuda")):
        agree(a, b, f"dse_mvr qsgd {what}", rtol=QSGD_RTOL, acc_tol=QSGD_ACC_TOL)
    print("dse_mvr qsgd steps/s: kernels %.1f, plain cuda %.1f, plain cpu %.1f" % (
        q_kernels["steps_per_s"], q_plain_cuda["steps_per_s"], q_plain_cpu["steps_per_s"]))

    # identity compression is structurally the uncompressed path
    uncompressed = run("dse_mvr", "cuda", use_fused=True)
    identity = run("dse_mvr", "cuda", use_fused=True, compression="identity")
    for k in ("train_loss", "consensus", "test_acc"):
        assert identity[k] == uncompressed[k], f"identity vs uncompressed: {k}"
    assert identity["launches"] == uncompressed["launches"]

    params = {k: v.unsqueeze(0).repeat((data.n_nodes,) + (1,) * v.dim())
              for k, v in mlp_init(0).items()}
    link = {c: link_bytes_per_round(make_algorithm("dse_mvr", 0.3, TAU, STEPS,
                                                   compression=c).comm, params)
            for c in (None, "qsgd")}
    raw, qsgd = sum(link[None].values()), sum(link["qsgd"].values())
    print(f"link bytes per round (8 nodes, both buffers): raw fp32 {raw:.0f} "
          f"{json.dumps(link[None])}, qsgd {qsgd:.0f} {json.dumps(link['qsgd'])}, "
          f"ratio {raw / qsgd:.3f}")

    # ---------------------------------------------------------------- 4
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_max_abs_err",
            "flips", "mlp_ms", "mlp_plain_ms")
    kernels = []
    for name, row in results.items():
        row["launches"] = sum(r["launches"].get(name, 0) for r in kernel_runs)
        assert row["launches"] > 0, f"{name} never launched on the main paths"
        kernels.append({k: row.get(k) for k in keys})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
