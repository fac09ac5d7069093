"""The port's serving path against the reference's, on the CPU.

On the reduced Gemma-2 2B, Yi-9B, RWKV-6 3B, Qwen1.5-MoE-A2.7B, Arctic
480B, Zamba2-7B and Qwen2-VL-2B (text prompts, M-RoPE positions broadcast
over its three streams), with the reference's parameters carried over
through numpy:

  * ``scan_prefill`` (decode steps into ring-buffer caches) against the
    reference's ``scan_prefill``: last logits rtol 1e-4 / atol 1e-5 and
    every cache leaf, ``pos`` exactly;
  * ``RequestDriver`` (3 slots, max_len 16, five requests of 3-6 prompt
    tokens and 5 new ones, as ``tests/test_serving.py`` drives the
    reference's) against the reference's driver on the same requests: the
    greedy tokens exactly;
  * the serve job and the serving CLI on the CPU (for the MoE and the
    Mamba-2 hybrid too: the bf16 prefill through the flash op, its caches
    continued by ``decode_fn``), and their refusal to run without a card
    unless the CPU is asked for;
  * a driver with a ``ServingMetrics`` records each run's requests per
    second.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.models import Model as JModel
from repro.serving import RequestDriver as JDriver
from repro.serving import scan_prefill as j_scan_prefill
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import Model, ModelConfig
from repro_torch.serving import RequestDriver, ServingMetrics, scan_prefill
from repro_torch.tree import tree_flatten

ARCHS = ("gemma2_2b", "yi_9b", "rwkv6_3b", "qwen2_moe_a2_7b", "arctic_480b", "zamba2_7b",
         "qwen2_vl_2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = JModel(j_reduced(arch))
            jp = jm.init(jax.random.key(0))
            cache[arch] = (jm, jp, Model(get_reduced(arch)),
                           params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
        return cache[arch]

    return get


def _workload(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, rng.integers(3, 7)).tolist(), 5) for _ in range(5)]


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_prefill_matches_reference(arch, built):
    jm, jp, tm, tp = built(arch)
    prompts = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = j_scan_prefill(jm, jp, jm.init_cache(2, 24, dtype=jnp.float32),
                            jnp.asarray(prompts), dtype=jnp.float32)
    tl, tc = scan_prefill(tm, tp, tm.init_cache(2, 24, dtype=torch.float32, device="cpu"),
                          torch.from_numpy(prompts), dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    leaves, _ = tree_flatten(tc)
    for g, w in zip(leaves, jax.tree.leaves(jc)):
        w = np.asarray(w)
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_request_driver_matches_reference(arch, built):
    jm, jp, tm, tp = built(arch)
    workload = _workload(jm.cfg.vocab_size)
    want = JDriver(jm, slots=3, max_len=16).run(jp, workload)
    got = RequestDriver(tm, slots=3, max_len=16, device="cpu").run(tp, workload)
    assert got["completed"] == want["completed"] == 5
    assert got["steps"] == want["steps"]
    for i in range(5):
        np.testing.assert_array_equal(got["outputs"][i], want["outputs"][i])
    # continuous batching changes no numbers: one request at a time agrees
    one = RequestDriver(tm, slots=1, max_len=16, device="cpu")
    for i, (prompt, n) in enumerate(workload):
        one.reset()
        np.testing.assert_array_equal(one.run(tp, [(prompt, n)])["outputs"][0],
                                      got["outputs"][i])


def test_request_driver_validation(built):
    _, _, tm, tp = built("yi_9b")
    driver = RequestDriver(tm, slots=2, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        driver.submit([], 4)
    with pytest.raises(ValueError):
        driver.submit([1, 2, 3, 4, 5], 4)   # 5 + 4 > max_len
    frame = Model(ModelConfig(name="frame", arch_type="dense", n_layers=1, d_model=16,
                              n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=32, head="frame"))
    with pytest.raises(ValueError, match="no decode path"):
        RequestDriver(frame, slots=2, max_len=8, device="cpu")
    metrics = ServingMetrics(bounds=(2,))
    driver = RequestDriver(tm, slots=2, max_len=8, device="cpu", metrics=metrics)
    res = driver.run(tp, [([1, 2, 3], 2), ([4, 5], 3)])
    rps = metrics.streams()["requests_per_sec"]
    assert rps.shape == (1,) and rps[0] == pytest.approx(res["requests_per_sec"])


def test_serve_job_on_cpu(built):
    """prefill_fn is Model.prefill in bf16 through the flash op;
    decode_fn drives the RequestDriver in bf16."""
    _, _, tm, tp = built("gemma2_2b")
    cfg = dataclasses.replace(tm.cfg, attn_impl="pallas")
    job = serve.make_serve_job(cfg, device="cpu")
    params = job.init_params(0)
    assert params["embed"].dtype == torch.bfloat16
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)))
    logits, caches = job.prefill_fn(params, {"tokens": tokens})
    want, _ = Model(cfg).prefill(params, {"tokens": tokens}, dtype=torch.bfloat16)
    assert logits.dtype == torch.bfloat16 and torch.equal(logits, want)
    assert caches["b0"]["attn"]["k"].shape == (cfg.repeats, 2, 40, cfg.n_kv_heads, cfg.hd)
    driver = RequestDriver(job.model, slots=2, max_len=16, dtype=torch.bfloat16,
                           decode_fn=job.decode_fn, device="cpu")
    out = driver.run(params, _workload(cfg.vocab_size)[:3])
    assert out["completed"] == 3 and all(len(o) == 5 for o in out["outputs"].values())


def test_rwkv_serve_job_on_cpu(built):
    """RWKV-6's prefill_fn with the wkv op (its plain version on the CPU),
    bf16; its caches continue through decode_fn as the driver's do."""
    _, _, tm, _ = built("rwkv6_3b")
    cfg = dataclasses.replace(tm.cfg, rwkv_chunk=16, rwkv_pallas=True)
    job = serve.make_serve_job(cfg, device="cpu")
    params = job.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    logits, caches = job.prefill_fn(params, {"tokens": tokens})
    want, _ = Model(cfg).prefill(params, {"tokens": tokens}, dtype=torch.bfloat16)
    assert logits.dtype == torch.bfloat16 and torch.equal(logits, want)
    rwkv = caches["b0"]["rwkv"]
    assert rwkv["wkv"].dtype == torch.float32 and rwkv["shift_t"].dtype == torch.bfloat16
    assert rwkv["wkv"].shape == (cfg.repeats, 2, cfg.d_model // 64, 64, 64)
    # one more token from the prefill's caches: the decode path reads them
    step, _ = job.decode_fn(params, caches, tokens[:, -1:], torch.full((2,), 32, dtype=torch.int32))
    assert step.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(step.float()).all())
    driver = RequestDriver(job.model, slots=2, max_len=16, dtype=torch.bfloat16,
                           decode_fn=job.decode_fn, device="cpu")
    out = driver.run(params, _workload(cfg.vocab_size)[:3])
    assert out["completed"] == 3 and all(len(o) == 5 for o in out["outputs"].values())


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "zamba2_7b"])
def test_moe_and_hybrid_serve_jobs_on_cpu(arch, built):
    """The bf16 prefill_fn through the flash op builds every element's
    caches (a MoE block's attention cache; Zamba2's Mamba-2 conv windows and
    fp32 states, and its shared block's attention cache, one per repeat),
    and decode_fn continues from them."""
    _, _, tm, _ = built(arch)
    cfg = dataclasses.replace(tm.cfg, attn_impl="pallas")
    job = serve.make_serve_job(cfg, device="cpu")
    params = job.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    logits, caches = job.prefill_fn(params, {"tokens": tokens})
    want, _ = Model(cfg).prefill(params, {"tokens": tokens}, dtype=torch.bfloat16)
    assert logits.dtype == torch.bfloat16 and torch.equal(logits, want)
    for i, kind in enumerate(cfg.block_unit):
        cache = caches[f"b{i}"]
        if kind == "mamba":
            mcfg = cfg.mamba_cfg()
            assert cache["mamba"]["ssm"].dtype == torch.float32
            assert cache["mamba"]["ssm"].shape == (cfg.repeats, 2, mcfg.n_heads,
                                                   mcfg.head_dim, mcfg.state_dim)
            assert cache["mamba"]["conv"].dtype == torch.bfloat16
        else:
            assert cache["attn"]["k"].shape == (cfg.repeats, 2, 32, cfg.n_kv_heads, cfg.hd)
    step, _ = job.decode_fn(params, caches, tokens[:, -1:], torch.full((2,), 32, dtype=torch.int32))
    assert step.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(step.float()).all())


@pytest.mark.parametrize("arch", ["gemma2-2b", "minitron-8b", "rwkv6-3b", "qwen2-moe-a2.7b",
                                  "zamba2-7b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                      "--prompt-len", "6", "--new-tokens", "5"])
    assert out["finite"] and out["tokens"].shape == (3, 5)
    assert "[serve] OK" in capsys.readouterr().out


def test_serving_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = get_reduced("yi-9b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_serve_job(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "yi-9b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init_cache(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RequestDriver(Model(cfg), slots=2, max_len=8)
