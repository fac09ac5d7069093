"""The port's LM model stack against the reference's, on the CPU.

For every arch (reduced Gemma-2 2B, Yi-9B, Minitron-8B, Command R+,
RWKV-6 3B, Qwen1.5-MoE-A2.7B, Arctic 480B, Zamba2-7B, Qwen2-VL-2B and
HuBERT X-Large), the reference's parameters (``model.init(
jax.random.key(0))``) go through numpy to the port, and the same inputs go
to both models (the reduced MoE configs' capacity factor of 8 drops no
token): S = 128 tokens, for Qwen2-VL 16 vision embeddings and 112 text
tokens (its loss reads the text positions), for HuBERT 128 frames of
random features with random frame targets:

  * ``forward`` logits, fp32, the auxiliary loss (the MoE router losses;
    0 elsewhere) and ``loss``, which adds it, within rtol 1e-5;
  * ``prefill`` with ``attn_impl="pallas"`` -- the reference's Pallas flash
    kernel in interpret mode, the port's flash op (its plain version on the
    CPU) -- at B = 2, S = 128: the last logits and every cache leaf
    (Gemma-2's reduced window of 16 masks at that length).  For RWKV-6,
    ``rwkv_chunk=16, rwkv_pallas=True``: the reference's Pallas wkv kernel
    in interpret mode computes the clamped chunked form, so it is held
    against the port's plain chunked path (the CUDA kernel's twin); the
    port's kernel branch, whose plain version on the CPU is the per-token
    recurrence, is held against the reference's kernel branch under its
    own CPU dispatch, which runs the same recurrence (on the reduced
    model's random weights some chunks' decay sums pass the -25 clamp, and
    the two forms differ there by about 6e-2 on the logits);
  * 12 ``decode_step``s from ``init_cache`` with an 8-slot ring buffer, so
    both the local and the global caches wrap (Zamba2's shared attention
    block's cache, one per repeat, too): logits at every step and the
    final caches, ``pos`` exactly.  HuBERT is an encoder with no decode
    path, so it is not among these cases; Qwen2-VL decodes text tokens;
  * the port's own ``init`` makes the reference's tree of shapes.

Tolerances: logits rtol 1e-4 / atol 1e-5 (fp32 through a few layers, each
side summing in its own order); cache k and v rtol 1e-5 / atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.kernels import api as japi
from repro.models import Model as JModel
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import Model, ModelConfig
from repro_torch.models.attention import AttentionConfig
from repro_torch.tree import tree_flatten, tree_map

B, S, DECODE_STEPS, RING = 2, 128, 12, 8
LOGITS = dict(rtol=1e-4, atol=1e-5)
CACHE = dict(rtol=1e-5, atol=1e-5)
DECODERS = tuple(a for a in ARCH_IDS if get_reduced(a).head == "lm")


def make_batch(cfg, seed: int = 1):
    """The model's inputs at B x S (numpy) and its loss targets: tokens, or
    a vision model's embeddings and text tokens, or an audio model's
    frames."""
    rng = np.random.default_rng(seed)
    if cfg.audio_frontend_dim:
        frames = rng.standard_normal((B, S, cfg.audio_frontend_dim)).astype(np.float32)
        return {"frames": frames}, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S - cfg.n_vision_tokens)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch, np.roll(tokens, -1, axis=1)


def j_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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
    """(reference model, its params, port model, port params, inputs) per
    arch, cached across the module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = j_reduced(arch)
            jm = JModel(jcfg)
            jp = jm.init(jax.random.key(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
            cache[arch] = (jm, jp, Model(get_reduced(arch)), tp, make_batch(jcfg)[0])
        return cache[arch]

    return get


def _close_tree(got, want, tol):
    g_leaves, g_def = tree_flatten(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.int32:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, built):
    jm, jp, tm, tp, batch = built(arch)
    jl, jaux = jm.forward(jp, j_batch(batch), dtype=jnp.float32)
    tl, aux = tm.forward(tp, t_batch(batch), dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert aux.dtype == torch.float32
    if "moe" in tm.cfg.block_unit:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    else:
        assert float(aux) == float(jaux) == 0.0
    targets = make_batch(jm.cfg)[1]
    jloss = jm.loss(jp, j_batch({**batch, "targets": targets}), dtype=jnp.float32)
    tloss = tm.loss(tp, t_batch({**batch, "targets": targets}), dtype=torch.float32)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def _prefill_pair(jm, jp, tm, tp, batch, j_mode):
    with japi.dispatch_mode(j_mode):
        jl, jc = jm.prefill(jp, j_batch(batch), dtype=jnp.float32)
    tl, tc = tm.prefill(tp, t_batch(batch), dtype=torch.float32)
    assert tl.shape == (B, 1, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    _close_tree(tc, jc, CACHE)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_through_flash_attention_matches_reference(arch, built):
    """HuBERT's bidirectional attention runs the plain ``_sdpa`` under
    ``attn_impl="pallas"`` too, in both packages (the kernel is causal)."""
    jm, jp, tm, tp, batch = built(arch)
    if "rwkv" not in tm.cfg.block_unit:
        _prefill_pair(JModel(dataclasses.replace(jm.cfg, attn_impl="pallas")), jp,
                      Model(dataclasses.replace(tm.cfg, attn_impl="pallas")), tp, batch,
                      "interpret")
        return
    kernel = dict(rwkv_chunk=16, rwkv_pallas=True)
    jm = JModel(dataclasses.replace(jm.cfg, **kernel))
    # the reference's Pallas kernel against the port's plain chunked path
    _prefill_pair(jm, jp, Model(dataclasses.replace(tm.cfg, rwkv_chunk=16)), tp, batch,
                  "interpret")
    # the kernel branch with each side's plain version of the op
    _prefill_pair(jm, jp, Model(dataclasses.replace(tm.cfg, **kernel)), tp, batch, "ref")


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_reference(arch, built):
    jm, jp, tm, tp, batch = built(arch)
    tokens = batch["tokens"]
    jc = jm.init_cache(B, RING, dtype=jnp.float32)
    tc = tm.init_cache(B, RING, dtype=torch.float32, device="cpu")
    _close_tree(tc, jc, CACHE)
    # the port starts from the reference's (empty) caches carried over
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    decode = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, dtype=jnp.float32))
    for step in range(DECODE_STEPS):
        pos = np.full((B,), step, np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tokens[:, step:step + 1]), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tokens[:, step:step + 1]),
                                torch.from_numpy(pos), dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    _close_tree(tc, jc, CACHE)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_makes_the_reference_tree(arch, built):
    jm, jp, _, _, _ = built(arch)
    tp = Model(get_reduced(arch)).init(0, device="cpu")
    leaves, _ = tree_flatten(tp)
    jleaves = jax.tree.leaves(jp)
    assert [tuple(t.shape) for t in leaves] == [j.shape for j in jleaves]
    assert all(t.dtype == torch.float32 for t in leaves)
    assert Model(get_reduced(arch)).cfg.param_count(tp) == jm.cfg.param_count(jp)
    again = Model(get_reduced(arch)).init(0, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(again["embed"], tp["embed"].to(torch.bfloat16))


def test_unported_kinds_raise():
    """An unknown arch (``ModuleNotFoundError``, as the reference's import
    raises) or block kind raises; every arch builds, at full width too (no
    parameters drawn), M-RoPE and the front ends included."""
    base = dict(name="t", arch_type="dense", n_layers=2, d_model=16, n_heads=2,
                n_kv_heads=1, d_ff=32, vocab_size=64)
    with pytest.raises(ModuleNotFoundError, match="gpt_2"):
        get_config("gpt-2")
    with pytest.raises(ValueError, match="nope"):
        Model(ModelConfig(**base, block_unit=("nope",)))
    for extra in (dict(audio_frontend_dim=8), dict(n_vision_tokens=4, vision_grid=(2, 2)),
                  dict(mrope_sections=(2, 1, 1))):
        assert Model(ModelConfig(**base, **extra)).cfg.name == "t"
    assert AttentionConfig(16, 2, 1, 8, mrope_sections=(2, 1, 1)).mrope_sections == (2, 1, 1)
    for arch in ("qwen2-moe-a2.7b", "arctic-480b", "zamba2-7b", "qwen2-vl-2b",
                 "hubert-xlarge"):
        assert Model(get_config(arch)).cfg.name == arch
        assert get_reduced(arch).name == f"{arch}-reduced"


@pytest.mark.parametrize("arch", ["gemma2_2b", "rwkv6_3b"])
def test_dropped_outputs_are_freed_without_the_garbage_collector(arch, built):
    """No reference cycle holds a prefill's logits and caches (or a
    tree_map's output): they are freed as soon as they are dropped."""
    import gc
    import weakref

    _, _, tm, tp, batch = built(arch)
    gc.collect()
    gc.disable()
    try:
        logits, caches = tm.prefill(tp, {"tokens": torch.from_numpy(batch["tokens"][:, :32])},
                                    dtype=torch.float32)
        mapped = tree_map(lambda t: t + 1, caches)
        refs = [weakref.ref(t) for t in [logits] + tree_flatten(caches)[0]
                + tree_flatten(mapped)[0]]
        del logits, caches, mapped
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()


def test_dropped_simulator_is_freed_without_the_garbage_collector():
    """No reference cycle holds a Simulator (its round step closes over the
    loss and the data, not over the Simulator): after a round, dropping it
    frees its copies of the data at once."""
    import gc
    import weakref

    from repro_torch import paper_problem as tproblem
    from repro_torch.core import NodeData, Simulator, ring

    n, per_node, batch, tau = 4, 16, 4, 2
    rng = np.random.default_rng(0)
    data = NodeData(rng.normal(size=(n, per_node, tproblem.DIM)).astype(np.float32),
                    rng.integers(0, tproblem.CLASSES, (n, per_node)).astype(np.int32))
    alg = tproblem.make_algorithm("dse_mvr", 0.3, tau, 8)
    gc.collect()
    gc.disable()
    try:
        sim = Simulator(alg, ring(n), tproblem.mlp_loss, data, batch, device="cpu")
        state = sim.run_rounds(sim.init_state(tproblem.mlp_init(0, hidden=8)), 1)
        assert state.step == tau
        refs = [weakref.ref(t) for t in (sim, sim._x, sim._y) + sim._full_flat]
        del sim, state
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()
