"""Qwen2-VL's M-RoPE and vision front end and HuBERT's audio encoder in
the port against the reference, on the CPU.

The same numpy inputs, made from a seed, go to both packages:

  * ``make_mrope_positions`` bit for bit (pure integer arithmetic);
    ``apply_mrope`` and ``layer_norm`` within rtol 1e-6 / atol 1e-6 (both
    compute in fp32; the rotation's angles reach a few hundred radians,
    where XLA's and ATen's sin and cos may round apart by an ulp);
  * the reduced Qwen2-VL-2B (16 vision embeddings and 112 text tokens) and
    HuBERT X-Large (128 frames), on the reference's parameters: ``forward``
    and ``loss`` with ``attn_impl="pallas"`` and ``prefill`` with
    ``attn_impl="xla"`` (``tests/test_torch_models.py`` holds the other
    pairing), the reference's flash op in interpret mode;
  * a caveat of the reference, pinned in both packages: Qwen2-VL's plain
    paths mask by M-RoPE's temporal positions, which are 0 on every vision
    token, so the vision block sees itself both ways, while the flash
    kernel is causal by index.  The two paths disagree on the vision rows
    (and, from the second layer on, on the text rows that read them);
  * HuBERT's bidirectional attention never reaches the flash op, and its
    serving CLI exits as encoder-only in both packages.

Tolerances: logits rtol 1e-4 / atol 1e-5 (the LM band of the model tests);
caches rtol 1e-5 / atol 1e-5; ``pos`` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.kernels import api as japi
from repro.launch import serve as j_serve
from repro.models import Model as JModel
from repro.models import common as jcommon
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api as tapi
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import common as tcommon
from repro_torch.tree import tree_flatten

B, S = 2, 128
ARCHS = ("qwen2_vl_2b", "hubert_xlarge")
LOGITS = dict(rtol=1e-4, atol=1e-5)
CACHE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small ops: beside other test
    workers, a pool of one OpenMP thread per core oversubscribes the CPU."""
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


def make_batch(cfg, seed: int = 5):
    """Inputs and targets (numpy): a vision model's embeddings and text
    tokens, or an audio model's frames."""
    rng = np.random.default_rng(seed)
    if cfg.audio_frontend_dim:
        return {"frames": rng.standard_normal((B, S, cfg.audio_frontend_dim)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    text = S - cfg.n_vision_tokens
    tokens = rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)
    return {"tokens": tokens,
            "vision_embeds": rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model))
            .astype(np.float32),
            "targets": np.roll(tokens, -1, axis=1)}


def pair(jm, tm, impl):
    return (JModel(dataclasses.replace(jm.cfg, attn_impl=impl)),
            Model(dataclasses.replace(tm.cfg, attn_impl=impl)))


@pytest.mark.parametrize("batch,seq,n_vis,grid", [
    (2, 128, 16, (4, 4)), (1, 300, 256, (16, 16)), (3, 40, 12, (3, 4)), (2, 9, 6, (2, 3)),
    (1, 16, 16, (4, 4)),
])
def test_mrope_positions_bit_for_bit(batch, seq, n_vis, grid):
    got = tcommon.make_mrope_positions(batch, seq, n_vis, grid, device="cpu")
    want = np.asarray(jcommon.make_mrope_positions(batch, seq, n_vis, grid))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="grid"):
        tcommon.make_mrope_positions(batch, seq, n_vis + 1, grid)


@pytest.mark.parametrize("hd,sections,theta,n_vis,grid", [
    (32, (4, 6, 6), 10000.0, 16, (4, 4)),
    (128, (16, 24, 24), 1e6, 256, (16, 16)),
])
def test_apply_mrope_matches_reference(hd, sections, theta, n_vis, grid):
    seq = n_vis + 64
    x = np.random.default_rng(0).standard_normal((2, seq, 3, hd)).astype(np.float32)
    pos = np.array(jcommon.make_mrope_positions(2, seq, n_vis, grid))
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # equal streams are plain RoPE
    flat = np.ascontiguousarray(np.broadcast_to(np.arange(seq, dtype=np.int32), (3, 2, seq)))
    same = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(flat), theta, sections)
    rope = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(flat[0]), theta)
    assert torch.equal(same, rope)
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, (1, 1, 1))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 7, 96)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(96).astype(np.float32), rng.standard_normal(96).astype(np.float32)
    jd, td = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jcommon.layer_norm(jnp.asarray(x).astype(jd), jnp.asarray(w),
                                         jnp.asarray(b)).astype(jnp.float32))
    got = tcommon.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w),
                             torch.from_numpy(b))
    assert got.dtype == td
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:   # both round the same fp32 value to bf16 once: at most one ulp apart
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_through_the_flash_op_match_reference(arch, built):
    jm, jp, tm, tp = built(arch)
    jm, tm = pair(jm, tm, "pallas")
    batch = make_batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with japi.dispatch_mode("interpret"):
        jl, _ = jm.forward(jp, jb, dtype=jnp.float32)
        jloss = jm.loss(jp, jb, dtype=jnp.float32)
    tapi.reset_counters()
    tl, aux = tm.forward(tp, tb, dtype=torch.float32)
    assert tl.shape == (B, S, tm.cfg.vocab_size) and float(aux) == 0.0
    # the kernel's op is reached only by the causal model, once a layer
    flash = tapi.call_counts().get("flash_attention", 0)
    assert flash == (tm.cfg.n_layers if tm.cfg.causal else 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    tloss = tm.loss(tp, tb, dtype=torch.float32)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_prefill_matches_reference(arch, built):
    """``prefill`` with ``attn_impl="xla"``: the last logits and every
    cache leaf; under M-RoPE the cached positions are the temporal stream."""
    jm, jp, tm, tp = built(arch)
    batch = {k: v for k, v in make_batch(jm.cfg).items() if k != "targets"}
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, dtype=jnp.float32)
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                        dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    leaves, _ = tree_flatten(tc)
    jleaves = jax.tree.leaves(jc)
    assert len(leaves) == len(jleaves)
    for g, w in zip(leaves, jleaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, **CACHE)
    if tm.cfg.n_vision_tokens:
        pos = tc["b0"]["attn"]["pos"][0]
        assert int(pos[:, :tm.cfg.n_vision_tokens].abs().max()) == 0


def test_vision_rows_differ_between_the_plain_and_flash_paths(built):
    """The reference's caveat, in both packages: on Qwen2-VL the plain
    path (vision block bidirectional by its temporal positions) and the
    flash path (causal by index) give different vision-row logits; each
    package's paths agree with the other package's same path."""
    jm0, jp, tm0, tp = built("qwen2_vl_2b")
    batch = make_batch(jm0.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    n_vis = jm0.cfg.n_vision_tokens
    logits = {}
    for impl in ("xla", "pallas"):
        jm, tm = pair(jm0, tm0, impl)
        with japi.dispatch_mode("interpret"):
            logits["j", impl] = np.asarray(jm.forward(jp, jb, dtype=jnp.float32)[0])
        logits["t", impl] = tm.forward(tp, tb, dtype=torch.float32)[0].numpy()
        np.testing.assert_allclose(logits["t", impl], logits["j", impl], **LOGITS)
    scale = np.abs(logits["j", "xla"]).max()
    for pkg in ("j", "t"):
        gap = np.abs(logits[pkg, "xla"] - logits[pkg, "pallas"])
        # the first vision token sees only itself under the causal kernel
        assert gap[:, :n_vis].max() > 0.1 * scale, (pkg, gap[:, :n_vis].max(), scale)
        assert gap[:, n_vis:].max() > 1e-3 * scale, (pkg, gap[:, n_vis:].max(), scale)


def test_encoder_has_no_decode_path(capsys):
    """HuBERT's serving CLI exits as the reference's does; its bidirectional
    prefill builds full-length caches through the plain attention."""
    for main in (serve.main, j_serve.main):
        with pytest.raises(SystemExit, match="encoder-only: no decode path"):
            main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"]
                 if main is serve.main else ["--arch", "hubert-xlarge", "--reduced"])
    cfg = dataclasses.replace(get_reduced("hubert-xlarge"), attn_impl="pallas")
    job = serve.make_serve_job(cfg, device="cpu")
    params = job.init_params(0)
    frames = torch.from_numpy(make_batch(cfg)["frames"])
    tapi.reset_counters()
    logits, caches = job.prefill_fn(params, {"frames": frames})
    assert tapi.call_counts() == {}
    assert logits.shape == (B, 1, cfg.vocab_size) and logits.dtype == torch.bfloat16
    assert caches["b0"]["attn"]["k"].shape == (cfg.repeats, B, S, cfg.n_kv_heads, cfg.hd)


def test_vision_serve_cli_decodes_text_prompts(capsys):
    """Qwen2-VL's serving CLI decodes text-only prompts, M-RoPE positions
    broadcast over the three streams, as the reference's does."""
    out = serve.main(["--arch", "qwen2-vl-2b", "--reduced", "--device", "cpu", "--requests", "2",
                      "--prompt-len", "6", "--new-tokens", "5"])
    assert out["finite"] and out["tokens"].shape == (2, 5)
    assert "[serve] OK" in capsys.readouterr().out
