"""The port's substrate against the reference on the CPU: the LM token
pipeline (bit for bit), the tree optimizers (rtol 1e-6 over 20 updates),
the schedules (exactly, but for the cosine's one fp32 ulp), the config
registry, and the codec paths that take a tree a leaf at a time (bit for
bit the whole-tree forms they replace).

The schedules return host floats that are the reference's fp32 values.
``cosine`` and ``warmup_cosine`` take the cosine on the host
(``schedules._cos32``: ``math.cos`` of the fp32 argument, rounded to fp32),
which is within one fp32 ulp of XLA's ``jnp.cos``; with XLA's cosine put in
its place every schedule value is the reference's bit for bit.
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import ShardedBatcher as JShardedBatcher
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import make_lm_tokens as j_make_lm_tokens
from repro.optim import adam as j_adam
from repro.optim import apply_updates as j_apply_updates
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import global_norm as j_global_norm
from repro.optim import momentum as j_momentum
from repro.optim import schedules as jsched
from repro.optim import sgd as j_sgd
from repro_torch import configs
from repro_torch.compression import ChocoChannel, Transport, make_compressor
from repro_torch.compression.gossip import neighbor_exchange, rotation_combine
from repro_torch.core import ring
from repro_torch.core.mixing import Rotation, roll_mix
from repro_torch.data import ShardedBatcher, TokenPipeline, make_lm_tokens
from repro_torch.kernels import api
from repro_torch.optim import adam, apply_updates, clip_by_global_norm, global_norm, momentum, sgd
from repro_torch.optim import schedules as tsched
from repro_torch.tree import map_tensors, tree_leaves, tree_map

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
N = 4
# a 3-leaf node-stacked tree for the codec paths
CODEC_SHAPES = {"b": (N, 7), "w": (N, 12, 10), "z": (N, 33)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small ops: beside other test
    workers, a pool of one OpenMP thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(rng, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _numpy_tree(rng, v) for k, v in shapes.items()}
    return rng.standard_normal(shapes).astype(np.float32)


def _as_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ----------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed", [0, 5])
def test_token_pipeline_and_batcher_are_the_reference_bit_for_bit(seed):
    tokens = make_lm_tokens(20_000, 512, seed=seed)
    np.testing.assert_array_equal(tokens, j_make_lm_tokens(20_000, 512, seed=seed))
    pipe, jpipe = TokenPipeline(tokens, 32, 8, seed=seed), JTokenPipeline(tokens, 32, 8, seed=seed)
    for _ in range(4):
        for got, want in zip(pipe.batch(), jpipe.batch()):
            np.testing.assert_array_equal(got, want)
    for (_, (gx, gy)), (_, (jx, jy)) in zip(zip(range(3), pipe), zip(range(3), jpipe)):
        np.testing.assert_array_equal(gx, jx)
        np.testing.assert_array_equal(gy, jy)
    sb = ShardedBatcher(TokenPipeline(tokens, 16, 8, seed=seed), 4)
    jsb = JShardedBatcher(JTokenPipeline(tokens, 16, 8, seed=seed), 4)
    for _ in range(3):
        for got, want in zip(sb.node_batches(), jsb.node_batches()):
            assert got.shape == (4, 2, 16)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedBatcher(TokenPipeline(tokens, 16, 6, seed=seed), 4).node_batches()
    with pytest.raises(ValueError, match="shorter than one sequence"):
        TokenPipeline(tokens[:10], 16, 2)


# --------------------------------------------------------------- optimizers
def _lr(kind):
    """The same learning rate for both packages: a constant, or a step
    decay (each package's own schedule: the port's takes host ints)."""
    if kind == "constant":
        return 0.05, 0.05
    return (tsched.step_decay(0.05, [4, 11], [0.5, 0.1]),
            jsched.step_decay(0.05, [4, 11], [0.5, 0.1]))


OPTIMIZERS = {
    "sgd": (sgd, j_sgd, {}),
    "momentum": (momentum, j_momentum, dict(beta=0.9)),
    "nesterov": (momentum, j_momentum, dict(beta=0.8, nesterov=True)),
    "adam": (adam, j_adam, {}),
}


@pytest.mark.parametrize("lr_kind", ["constant", "callable"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_the_reference(name, lr_kind):
    make, jmake, kw = OPTIMIZERS[name]
    tlr, jlr = _lr(lr_kind)
    opt, jopt = make(tlr, **kw), jmake(jlr, **kw)
    rng = np.random.default_rng(3)
    p0 = _numpy_tree(rng)
    tp, jp = _as_torch(p0), _as_jax(p0)
    ts, js = opt.init(tp), jopt.init(jp)
    for _ in range(20):
        g = _numpy_tree(rng)
        tu, ts = opt.update(_as_torch(g), ts, tp)
        ju, js = jopt.update(_as_jax(g), js, jp)
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
        tp, jp = apply_updates(tp, tu), j_apply_updates(jp, ju)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
    if name == "adam":   # fp32 moments whatever the parameters' dtype
        bf = opt.init(tree_map(lambda t: t.to(torch.bfloat16), tp))
        assert all(m.dtype == torch.float32 for m in tree_leaves(bf["m"]))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clipping_match_the_reference(max_norm):
    tree = _numpy_tree(np.random.default_rng(4))
    got, want = global_norm(_as_torch(tree)), j_global_norm(_as_jax(tree))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPT_TOL)
    clipped, jclipped = clip_by_global_norm(_as_torch(tree), max_norm), j_clip(_as_jax(tree),
                                                                             max_norm)
    for a, b in zip(tree_leaves(clipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)


# ---------------------------------------------------------------- schedules
SCHEDULES = {
    "constant": lambda m: m.constant(0.3),
    "step_decay": lambda m: m.step_decay(0.2, [7, 19, 40], [0.5, 0.3, 0.01]),
    "paper_mnist": lambda m: m.paper_mnist_schedule(0.4, 50),
    "paper_cifar": lambda m: m.paper_cifar_schedule(0.1, 50),
    "decay_weight": lambda m: m.decay_weight(0.05, 0.97),
    "cosine": lambda m: m.cosine(0.1, 40),
    "cosine_floor": lambda m: m.cosine(0.3, 37, 0.2),
    "warmup_cosine": lambda m: m.warmup_cosine(0.1, 8, 40),
    "warmup_cosine_zero": lambda m: m.warmup_cosine(1.7, 13, 50, 0.0),
}


def _xla_cos32(x) -> np.float32:
    return np.float32(np.asarray(jnp.cos(jnp.float32(x))))


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_are_the_reference_fp32_values(name, monkeypatch):
    """Every schedule at t = 0..59 is the reference's fp32 value, bit for
    bit, once the cosine is XLA's; with the host cosine a cosine schedule
    is the reference's arithmetic on a cosine one ulp off at most."""
    mk = SCHEDULES[name]
    want = [np.asarray(mk(jsched)(t)) for t in range(60)]
    assert all(w.dtype == np.float32 for w in want)
    host = [mk(tsched)(t) for t in range(60)]
    assert all(isinstance(v, float) for v in host)
    monkeypatch.setattr(tsched, "_cos32", _xla_cos32)
    assert [mk(tsched)(t) for t in range(60)] == [float(w) for w in want]
    if "cosine" not in name:
        assert host == [float(w) for w in want]
    else:
        # one ulp of the cosine moves base * (1 - floor) / 2 * (1 + c) by
        # at most that much over the value's own rounding: 2 ulps here
        assert max(_ulps(h, w) for h, w in zip(host, want)) <= 2


def test_host_cosine_is_within_one_ulp_of_xla():
    x = np.linspace(0.0, math.pi, 200_001, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.cos)(x))
    got = np.array([tsched._cos32(v) for v in x[::97]], dtype=np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want[::97].view(np.int32))
    assert ulps.max() <= 1


# ----------------------------------------------------------------- registry
def test_config_registry_finds_a_registered_module_and_lists_every_arch():
    from repro.configs import all_configs as j_all_configs
    from repro_torch.models import ModelConfig

    cfg = ModelConfig(name="lm-test", arch_type="dense", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=1, d_ff=32, vocab_size=64, block_unit=("attn",))
    module = type(sys)("repro_torch.configs.lm_test")
    module.config = lambda: cfg
    module.reduced = lambda: cfg
    sys.modules["repro_torch.configs.lm_test"] = module
    try:
        assert configs.get_config("lm-test") is cfg
        assert configs.get_reduced("lm_test") is cfg
    finally:
        del sys.modules["repro_torch.configs.lm_test"]
    with pytest.raises(ModuleNotFoundError):
        configs.get_config("lm-test")
    got, want = configs.all_configs(), j_all_configs()
    assert list(got) == list(want) == configs.ARCH_IDS
    assert [c.name for c in got.values()] == [c.name for c in want.values()]


# ----------------------------------------------------- leaf-at-a-time paths
def _codec_tree(seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in CODEC_SHAPES.items()}


def _equal(a, b):
    """Trees (or lists of tensors) equal bit for bit."""
    la, lb = (a, b) if isinstance(a, list) else (tree_leaves(a), tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _seed(i):
    return 1000 + 7 * i


@pytest.mark.parametrize("spec", ["qsgd", "top_k:0.25"])
@pytest.mark.parametrize("feedback", [True, False])
def test_leaf_by_leaf_roundtrip_is_the_whole_tree_one(spec, feedback):
    comp = make_compressor(spec, error_feedback=feedback)
    x, e = _codec_tree(1), _codec_tree(2)
    payload, dec, new_res = comp.roundtrip(x, e if feedback else None, _seed)
    inner = comp.inner if feedback else comp
    inp = tree_map(lambda a, b: a + b, x, e) if feedback else x
    want = inner.encode_tree(inp, _seed)
    _equal([p.data[k] for p in tree_leaves(payload) for k in sorted(p.data)],
           [p.data[k] for p in tree_leaves(want) for k in sorted(p.data)])
    _equal(dec, inner.decode_tree(want))
    if feedback:
        _equal(new_res, tree_map(lambda a, d: a - d, inp, inner.decode_tree(want)))
    else:
        assert new_res is None


def test_rotation_combine_decodes_a_leaf_at_a_time_bit_for_bit():
    comp = make_compressor("qsgd", error_feedback=False)
    rot = Rotation.from_topology(ring(N))
    payload = comp.encode_tree(_codec_tree(3), _seed)
    dec = comp.decode_tree(payload)
    got = rotation_combine(comp, (rot,))(payload, dec, None)
    acc = tree_map(lambda d: rot.self_weight * d, dec)
    for s, w in zip(rot.shifts, rot.weights):
        rolled = comp.decode_tree(map_tensors(lambda a: torch.roll(a, -s, 0), payload))
        acc = tree_map(lambda a, d: a + w * d, acc, rolled)
    _equal(got, acc)


def _choco_rounds(wire_mode: str, in_place: bool, rounds: int = 3):
    """``rounds`` CHOCO top-k events on ring(N) through the channel's own
    paths, and the same through whole-tree steps written out here."""
    comp = make_compressor("top_k:0.25")
    rot = Rotation.from_topology(ring(N))
    if wire_mode == "neighbor":
        ex = neighbor_exchange((rot,))
        chan = ChocoChannel(compression=comp, neighbor_shifts=ex.shifts, in_place=in_place,
                            gamma=0.8)
        transport = Transport(roll_mix(ring(N)), neighbor=ex)
    else:
        ex = None
        chan = ChocoChannel(compression=comp, in_place=in_place, gamma=0.8)
        transport = Transport(roll_mix(ring(N)))
    comp = chan.compression   # choco drops error feedback
    wire = chan.init_wire(_codec_tree(0))
    hat = tree_map(torch.zeros_like, _codec_tree(0))
    nbr = [tree_map(torch.zeros_like, hat) for _ in (ex.shifts if ex else ())]
    outs, want = [], []
    for r in range(rounds):
        x = _codec_tree(10 + r)
        out, wire = chan.gossip(x, wire, _seed, transport)
        # copies: an in-place wire's trees are the next round's too
        outs.append(map_tensors(torch.clone, (out, wire["hat"], wire.get("nbr", ()))))
        # whole trees: encode, decode, advance the replicas, mix, consensus
        payload = comp.encode_tree(tree_map(lambda a, h: a - h, x, hat), _seed)
        hat = tree_map(lambda h, d: h + d, hat, comp.decode_tree(payload))
        if ex is None:
            mixed = roll_mix(ring(N))(hat)
        else:
            nbr = [tree_map(lambda h, d: h + d, n_k, comp.decode_tree(ex.roll(payload, s)))
                   for n_k, s in zip(nbr, ex.shifts)]
            mixed = ex.contract(hat, nbr, None)
        y = tree_map(lambda a, m, h: a + 0.8 * (m - h), x, mixed, hat)
        want.append((y, hat, tuple(nbr)))
    return outs, want


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("wire_mode", ["neighbor", "dense"])
def test_choco_leaf_by_leaf_and_in_place_wires_are_the_whole_tree_ones(wire_mode, in_place):
    outs, want = _choco_rounds(wire_mode, in_place)
    for (out, hat, nbr), (y, w_hat, w_nbr) in zip(outs, want):
        _equal(out, y)
        _equal(hat, w_hat)
        assert len(nbr) == len(w_nbr)
        for a, b in zip(nbr, w_nbr):
            _equal(a, b)


def test_choco_in_place_advances_the_given_replicas():
    comp = make_compressor("top_k:0.25")
    chan = ChocoChannel(compression=comp, in_place=True)
    wire = chan.init_wire(_codec_tree(0))
    before = [t.data_ptr() for t in tree_leaves(wire["hat"])]
    _, new = chan.gossip(_codec_tree(5), wire, _seed, Transport(roll_mix(ring(N))))
    assert [t.data_ptr() for t in tree_leaves(new["hat"])] == before
    _, fresh = ChocoChannel(compression=comp).gossip(
        _codec_tree(5), ChocoChannel(compression=comp).init_wire(_codec_tree(0)), _seed,
        Transport(roll_mix(ring(N))))
    assert all(a.data_ptr() not in before for a in tree_leaves(fresh["hat"]))


def test_large_leaves_get_buckets_of_their_own_bit_for_bit(monkeypatch):
    """A leaf of ``OWN_BUCKET`` elements or more is dispatched alone, its
    inputs as views; the results are those of one bucket."""
    trees = [_codec_tree(s) for s in (1, 2, 3)]
    want = api.tree_mvr_update(*trees, 0.3)
    monkeypatch.setattr(api, "OWN_BUCKET", 100)   # w (480) and z (132) alone
    assert api.bucket_count(trees[0]) == 3
    api.reset_counters()
    got = api.tree_mvr_update(*trees, 0.3)
    assert api.call_counts() == {"mvr_update": 3}
    _equal(got, want)
    monkeypatch.setattr(api, "OWN_BUCKET", 10_000)
    assert api.bucket_count(trees[0]) == 1
