"""Sharding profiles and logical parameter axes against the reference, in
one process (no devices: resolution logic only; the layouts' runs are in
``test_torch_layout_group.py``).

The port's spec is a tuple, one entry a dim; the reference's is a
``PartitionSpec``, compared as ``tuple(P)``.  Meshes are the reference's
``FakeMesh`` pattern: an object with ``axis_names`` and ``devices.shape``.
"""
import hashlib

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.launch.sharding import PROFILES as J_PROFILES
from repro.launch.sharding import cache_specs as j_cache_specs
from repro.launch.sharding import profile_for_arch as j_profile_for_arch
from repro.models import Model as JModel
from repro.models import axis_rules as j_axis_rules
from repro.models import resolve_specs as j_resolve_specs
from repro.models.common import _resolve_axes as j_resolve_axes
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.sharding import ARCH_PROFILE, PROFILES, cache_specs, profile_for_arch
from repro_torch.models import Model
from repro_torch.models.common import LogicalAxes, _resolve_axes, axis_rules, resolve_specs
from repro_torch.tree import tree_leaves

ARCHS = ("arctic_480b", "command_r_plus_104b", "gemma2_2b", "hubert_xlarge", "minitron_8b",
         "qwen2_moe_a2_7b", "qwen2_vl_2b", "rwkv6_3b", "yi_9b", "zamba2_7b")
# sha256 (first 16 hex digits) of Model(get_reduced(arch)).init(0, device="cpu")'s
# leaves, as drawn before the parameters took their axes
INIT_SHA = {
    "arctic_480b": "458ca80f485bb177",
    "command_r_plus_104b": "3d488b816b16e1be",
    "gemma2_2b": "3c7ec2a57d695a2e",
    "hubert_xlarge": "db490fd582eb1deb",
    "minitron_8b": "e96ccef6786a9675",
    "qwen2_moe_a2_7b": "c6b79f29f473e90c",
    "qwen2_vl_2b": "04687468e9cde475",
    "rwkv6_3b": "4b44701e9f8ad8e7",
    "yi_9b": "57a03fd87678751d",
    "zamba2_7b": "457636662db55ca5",
}


def fake_mesh(shape, names=("data", "model")):
    class FakeMesh:
        axis_names = names

        class devices:
            pass

    FakeMesh.devices.shape = tuple(shape)
    return FakeMesh()


MESHES = {"4x2": fake_mesh((4, 2)), "16x16": fake_mesh((16, 16)),
          "pod2x16x16": fake_mesh((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec):
    """A spec with one-axis tuples as the axis (``PartitionSpec`` keeps
    ``("data",)`` as ``"data"`` in newer JAX: the same layout)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _j_specs(tree):
    return [_norm(s) for s in jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, P))]


def test_resolution_divisibility_fallback():
    mesh = MESHES["pod2x16x16"]
    with axis_rules({"heads": "model", "ffn": "model"}, mesh=mesh):
        # 8 heads do not divide by 16: replicated; 9216 hidden units do
        assert _resolve_axes(("heads", "ffn"), (8, 9216)) == (None, "model")
    with j_axis_rules({"heads": "model", "ffn": "model"}, mesh=mesh):
        assert tuple(j_resolve_axes(("heads", "ffn"), (8, 9216))) == (None, "model")


@pytest.mark.parametrize("shape", [(128, 4864), (60, 1408), (64, 64), (3, 5)])
def test_resolution_uses_an_axis_once(shape):
    """The first divisible dim wins the axis (Qwen2-MoE's 60 experts do not
    divide 16, so the expert-hidden dim shards instead), as the
    reference resolves it."""
    mesh = MESHES["pod2x16x16"]
    rules = {"experts": "model", "ffn": "model"}
    with axis_rules(rules, mesh=mesh):
        got = _resolve_axes(("experts", "ffn"), shape)
    with j_axis_rules(rules, mesh=mesh):
        want = tuple(j_resolve_axes(("experts", "ffn"), shape))
    assert got == want
    assert {(128, 4864): ("model", None), (60, 1408): (None, "model")}.get(shape, got) == got


def test_resolution_without_a_mesh_and_with_axis_tuples():
    rules = {"batch": ("pod", "data"), "embed": "data", "vocab": None}
    for shape in (None, (6, 7, 8)):
        with axis_rules(rules):
            got = _resolve_axes(("batch", "embed", "vocab"), shape)
        with j_axis_rules(rules):
            want = tuple(j_resolve_axes(("batch", "embed", "vocab"), shape))
        # 'data' went to the batch: the embedding replicates
        assert got == want == (("pod", "data"), None, None)
    with axis_rules(rules, mesh=MESHES["pod2x16x16"]):
        assert _resolve_axes(("batch", "embed"), (6, 32)) == (None, "data")
        assert LogicalAxes(("embed", "batch"), (16, 64)).spec() == ("data", None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ["tp", "fsdp", "2d"])
def test_profiles_and_rule_tables(name, mesh):
    m = MESHES[mesh]
    got, want = PROFILES[name], J_PROFILES[name]
    assert got.data_axes(m) == want.data_axes(m)
    assert got.node_axes(m) == want.node_axes(m)
    assert got.n_nodes(m) == want.n_nodes(m)
    for table in ("train_rules", "train_param_rules", "serve_rules", "serve_param_rules"):
        assert getattr(got, table)(m) == getattr(want, table)(m), table


@pytest.mark.parametrize("arch", sorted(ARCH_PROFILE) + [
    "yi-9b-reduced", "yi_9b", "qwen2-moe-a2.7b", "lm-100m", "unknown-arch"])
def test_profile_for_arch(arch):
    assert profile_for_arch(arch).name == j_profile_for_arch(arch).name


@pytest.mark.parametrize("mesh", ["4x2", "16x16"])
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_resolve_as_the_reference(arch, profile, mesh):
    """``resolve_specs(Model.param_specs())`` under the profile's training
    rules, node-axis prefix included, equals the reference's at full size,
    leaf for leaf; every spec has a parameter's rank (plus the node dim)."""
    m = MESHES[mesh]
    prof, j_prof = PROFILES[profile], J_PROFILES[profile]
    with axis_rules(prof.train_rules(m), m, param_rules=prof.train_param_rules(m)):
        got = [_norm(s) for s in tree_leaves(resolve_specs(
            Model(get_config(arch)).param_specs(), prefix=(prof.node_axes(m),)))]
    with j_axis_rules(j_prof.train_rules(m), m, param_rules=j_prof.train_param_rules(m)):
        want = _j_specs(j_resolve_specs(JModel(j_get_config(arch)).param_specs(),
                                        prefix=(j_prof.node_axes(m),)))
    assert got == want
    shapes = tree_leaves(Model(get_config(arch)).param_shapes())
    assert [len(s) for s in got] == [t.dim() + 1 for t in shapes]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_follow_the_parameters(arch):
    """``param_specs`` names every parameter's dims with its shape, blocks
    stacked over ``"layers"``, and the same names as the reference; the
    serve rules resolve as the reference's with no prefix."""
    model = Model(get_reduced(arch))
    specs = tree_leaves(model.param_specs())
    shapes = tree_leaves(model.param_shapes())
    assert all(isinstance(s, LogicalAxes) for s in specs)
    assert [s.shape for s in specs] == [tuple(t.shape) for t in shapes]
    j_specs = jax.tree.leaves(JModel(j_get_reduced(arch)).param_specs(),
                              is_leaf=lambda s: hasattr(s, "names"))
    assert [s.names for s in specs] == [tuple(s.names) for s in j_specs]
    m, prof = MESHES["16x16"], PROFILES["tp"]
    with axis_rules(prof.serve_rules(m), m, param_rules=prof.serve_param_rules(m)):
        got = tree_leaves(resolve_specs(model.param_specs()))
    with j_axis_rules(prof.serve_rules(m), m, param_rules=prof.serve_param_rules(m)):
        want = _j_specs(j_resolve_specs(JModel(j_get_reduced(arch)).param_specs()))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_unchanged_by_the_axes(arch):
    """The axes change no drawn parameter: the same bits as before."""
    h = hashlib.sha256()
    for t in tree_leaves(Model(get_reduced(arch)).init(0, device="cpu")):
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_SHA[arch]


@pytest.mark.parametrize("case", ["plain", "mesh", "seq_shard"])
@pytest.mark.parametrize("arch", ["gemma2_2b", "zamba2_7b", "rwkv6_3b", "qwen2_vl_2b"])
def test_cache_specs_as_the_reference(arch, case):
    """The decode caches' specs by leaf name: attention's k / v / pos,
    Mamba-2's conv / ssm, RWKV's wkv and token shifts, with and without the
    divisibility check, and sequence-sharded at batch 1."""
    batch = 1 if case == "seq_shard" else 8
    kw = {"plain": dict(batch_axes=("data",)),
          "mesh": dict(batch_axes=("data",), mesh=MESHES["16x16"]),
          "seq_shard": dict(batch_axes=None, mesh=MESHES["16x16"], seq_shard_axes=("data",))}[case]
    cache = Model(get_reduced(arch)).init_cache(batch, 64, torch.bfloat16, device="cpu")
    j_cache = jax.eval_shape(lambda: JModel(j_get_reduced(arch)).init_cache(batch, 64,
                                                                            jnp.bfloat16))
    got = [_norm(s) for s in tree_leaves(cache_specs(cache, **kw))]
    want = _j_specs(j_cache_specs(j_cache, **kw))
    assert got == want
    assert [len(s) for s in got] == [t.dim() for t in tree_leaves(cache)]
