"""The wkv_chunk kernel's grouped carry, mirrored on the CPU.

The CUDA kernel cuts each (b, h) sequence into groups of chunks: pass A
folds each group's chunks into a state increment and a decay product, pass
B carries the state across the groups, pass C replays each group from its
entering state.  ``wkv_grouped_ref`` computes those passes in PyTorch, in
the kernel's order, at the kernel's group size for each chunk.  The same
numpy inputs go through it, through the plain chunked form
``wkv_chunked_ref`` and through the reference's Pallas kernel in interpret
mode (as ``tests/test_torch_rwkv.py`` runs it), under weak decay and under
strong decay, where the +-25 clamp bites.  Chunk counts: fewer chunks than
one group, a whole number of groups, and a ragged last group (37 chunks).

Tolerance rtol / atol 1e-5 on y and the final state, the band the kernel is
held to on the card: the grouped carry only reassociates the decay
products across a group's chunks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv_chunk.kernel import wkv_chunk_fwd as j_wkv_kernel
from repro_torch.kernels.wkv_chunk.kernel import group_size
from repro_torch.kernels.wkv_chunk.ref import wkv_chunked_ref, wkv_grouped_ref

TIGHT = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b, s, h, p, decay):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5 for _ in range(3))
    logw = (-decay * np.exp(rng.standard_normal((b, s, h, p)) * 0.3)).astype(np.float32)
    return r, k, v, logw


def _n_chunks(kind, group):
    return {"under_one_group": 3, "whole_groups": 2 * group, "ragged": 37}[kind]


@pytest.mark.parametrize("kind", ["under_one_group", "whole_groups", "ragged"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("p", [16, 32, 64])
def test_grouped_carry_matches_chunked_form(p, chunk, kind):
    group = group_size(chunk)
    n = _n_chunks(kind, group)
    assert (n < group) == (kind == "under_one_group")
    assert (n % group != 0) == (kind != "whole_groups")
    for decay in (0.3, 3.0):
        x = _inputs(p * 1000 + chunk * 10 + n, 2, n * chunk, 2, p, decay)
        if decay == 3.0 and chunk >= 16:
            sums = x[3].reshape(2, n, chunk, 2, p).sum(axis=2)
            assert (sums < -25).any()   # the clamp bites
        tx = [torch.from_numpy(t) for t in x]
        y, state = wkv_grouped_ref(*tx, chunk, group)
        y_want, s_want = wkv_chunked_ref(*tx, chunk)
        assert y.shape == y_want.shape and state.shape == s_want.shape
        torch.testing.assert_close(y, y_want, **TIGHT)
        torch.testing.assert_close(state, s_want, **TIGHT)


# the reference's Pallas kernel (interpret mode) at the ragged count, under
# strong decay for every (P, chunk) and once under weak decay
PALLAS_CASES = [(p, chunk, 3.0) for p in (16, 32, 64) for chunk in (8, 16, 32)] + [(64, 16, 0.3)]


@pytest.mark.parametrize("p,chunk,decay", PALLAS_CASES)
def test_grouped_carry_matches_reference_pallas_kernel(p, chunk, decay):
    n = _n_chunks("ragged", group_size(chunk))
    x = _inputs(p + chunk + int(decay * 10), 1, n * chunk, 2, p, decay)
    want = j_wkv_kernel(*map(jnp.asarray, x), chunk=chunk, interpret=True)
    got = wkv_grouped_ref(*map(torch.from_numpy, x), chunk, group_size(chunk))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), **TIGHT)


@pytest.mark.parametrize("group", [1, 5, 64])
def test_grouped_carry_any_group_size(group):
    """Groups of one chunk are the plain chunked carry; a group longer than
    the sequence is one pass over it; both agree with the chunked form."""
    x = [torch.from_numpy(t) for t in _inputs(group, 1, 20 * 16, 3, 32, 1.0)]
    y, state = wkv_grouped_ref(*x, 16, group)
    y_want, s_want = wkv_chunked_ref(*x, 16)
    torch.testing.assert_close(y, y_want, **TIGHT)
    torch.testing.assert_close(state, s_want, **TIGHT)
