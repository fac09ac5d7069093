"""Fused-op backend of the port: one registry for the hand-written kernels.

Counterpart of ``repro.kernels.api``.  An op is a :class:`FusedOp`: a plain
PyTorch version (``ref_fn``) and a hand-written kernel.  An elementwise op's
kernel works over flat buffers (``launch``): :func:`tree_apply` flattens
whole parameter trees into one contiguous 1-D buffer per dtype bucket and
makes ONE launch per bucket.  A shaped op's kernel takes the tensors as
they are, with static keyword arguments (``launch_shaped``), and
:func:`call` makes one launch per call.

Dispatch follows the tensors' device, never a silent fallback:

  * CPU tensors run the plain version;
  * CUDA tensors launch the kernel, or raise (a missing ``triton`` raises
    ``ImportError`` and a missing ``nvcc`` ``RuntimeError`` at the first
    launch);
  * :func:`dispatch_mode` ``("ref")`` runs the plain version on CUDA
    tensors too -- the only way to get it there, used to hold each kernel
    against its plain version.

Every op is differentiable, as the reference's ref-backed ``custom_vjp``s
are: where grad mode is on and an input requires grad, the dispatch runs
inside a ``torch.autograd.Function`` whose forward dispatches as above and
whose backward recomputes the plain version (``ref_fn``, or the flat
``_flat_ref``) on the saved inputs and differentiates it.  The backward
launches no kernel and counts nothing.  Integer inputs get no gradient,
and neither do the scalar operands, which are host numbers.  Without grad
(the serving and training paths of the paper problem), the call is the
plain dispatch.

The TPU's lane padding (``TilePolicy``) has no counterpart: the kernels mask
the ragged tail of a buffer.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_unflatten

Tree = object

__all__ = [
    "FusedOp", "REGISTRY", "register", "get", "MODES", "dispatch_mode",
    "tree_apply", "bucket_count", "OWN_BUCKET", "call", "tree_mvr_update", "tree_axpby",
    "tree_add_sub",
    "tree_dse_combine", "tree_dse_combine_yh",
    "launch_counts", "call_counts", "reset_counters",
]

MODES = ("kernel", "ref")
_mode = "kernel"
#: leaves of this many elements or more get a tree_apply bucket of their own
OWN_BUCKET = 1 << 24


@contextlib.contextmanager
def dispatch_mode(mode: str):
    """Force a dispatch mode for the block: ``"ref"`` runs the plain version
    on every device; ``"kernel"`` (the default) launches on CUDA."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    global _mode
    prev, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = prev


# ---------------------------------------------------------------- accounting
_launches: Counter = Counter()   # kernel launches
_calls: Counter = Counter()      # dispatches of any kind, one per dtype bucket


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last reset."""
    return dict(_launches)


def call_counts() -> Dict[str, int]:
    """Dispatches per op since the last reset (plain version included)."""
    return dict(_calls)


def reset_counters() -> None:
    _launches.clear()
    _calls.clear()


# ---------------------------------------------------------------- the op
@dataclasses.dataclass(frozen=True, eq=False)
class FusedOp:
    """A fused op: elementwise (``launch``) or shaped (``launch_shaped``).

    ref_fn:  plain PyTorch version.  Elementwise: ``ref_fn(*tensors,
             *scalars)``, computing in fp32 (outputs cast to their
             ``out_dtype_from`` dtype).  Shaped: ``ref_fn(*tensors,
             **static)``.
    launch:  elementwise kernel ``launch(scalars, ins, outs)`` over
             contiguous 1-D CUDA buffers; fp32 compute, cast on store.
    launch_shaped: shaped kernel ``launch_shaped(*tensors, **static)`` on
             CUDA tensors; allocates and returns its output.
    out_dtype_from: per output of an elementwise op, the input whose dtype
             it takes.
    """

    name: str
    ref_fn: Callable
    n_inputs: int
    launch: Optional[Callable] = None
    launch_shaped: Optional[Callable] = None
    n_outputs: int = 1
    n_scalars: int = 0
    out_dtype_from: Tuple[int, ...] = (0,)
    doc: str = ""

    def __post_init__(self):
        if (self.launch is None) == (self.launch_shaped is None):
            raise ValueError(f"{self.name}: give exactly one of launch, launch_shaped")
        if self.n_inputs <= 0:
            raise ValueError(f"{self.name}: ops need n_inputs")
        if self.launch is not None and len(self.out_dtype_from) != self.n_outputs:
            raise ValueError(f"{self.name}: out_dtype_from vs n_outputs")

    @property
    def elementwise(self) -> bool:
        return self.launch is not None


REGISTRY: Dict[str, FusedOp] = {}


def register(op: FusedOp) -> FusedOp:
    """Add an op; re-registering a name with other functions is an error."""
    prev = REGISTRY.get(op.name)
    fns = lambda o: (o.launch, o.launch_shaped, o.ref_fn)  # noqa: E731
    if prev is not None and fns(prev) != fns(op):
        raise ValueError(f"fused op {op.name!r} is already registered")
    REGISTRY[op.name] = op
    return op


def get(name: str) -> FusedOp:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown fused op {name!r}; registered: {sorted(REGISTRY)}"
        ) from None


def _fp32(s) -> float:
    """A host scalar rounded to fp32 (the kernels take fp32 arguments)."""
    if isinstance(s, torch.Tensor):
        raise TypeError("fused-op scalars are host numbers, not tensors")
    return float(np.float32(s))


def _flat_ref(op: FusedOp, scalars, bufs, out_dtypes):
    outs = op.ref_fn(*(b.float() for b in bufs), *scalars)
    if not isinstance(outs, tuple):
        outs = (outs,)
    return tuple(o.to(d) for o, d in zip(outs, out_dtypes))


def _flat_launch(op: FusedOp, scalars, bufs, out_dtypes):
    bufs = tuple(b.contiguous() for b in bufs)
    outs = tuple(
        torch.empty(bufs[0].shape, dtype=d, device=bufs[0].device)
        for d in out_dtypes
    )
    _launches[op.name] += 1
    op.launch(scalars, bufs, outs)
    return outs


def _flat_dispatch(op: FusedOp, scalars, bufs, out_dtypes):
    device = bufs[0].device
    _calls[op.name] += 1
    if device.type == "cpu" or _mode == "ref":
        return _flat_ref(op, scalars, bufs, out_dtypes)
    if device.type == "cuda":
        return _flat_launch(op, scalars, bufs, out_dtypes)
    raise ValueError(f"{op.name}: no kernel for device {device}")


def _shaped_dispatch(op: FusedOp, tensors, kw):
    device = tensors[0].device
    _calls[op.name] += 1
    if device.type == "cpu" or _mode == "ref":
        return op.ref_fn(*tensors, **kw)
    if device.type == "cuda":
        _launches[op.name] += 1
        return op.launch_shaped(*tensors, **kw)
    raise ValueError(f"{op.name}: no kernel for device {device}")


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RefGrad(torch.autograd.Function):
    """A dispatch whose gradient is its plain version's: ``forward`` runs
    ``dispatch`` (the kernel on the card), ``backward`` recomputes ``ref``
    on the saved inputs and differentiates it (no launch, no count)."""

    @staticmethod
    def forward(ctx, dispatch, ref, *tensors):
        ctx.ref = ref
        ctx.save_for_backward(*tensors)
        return dispatch(*tensors)

    @staticmethod
    def backward(ctx, *cts):
        inputs = ctx.saved_tensors
        needs = [bool(n) and t.is_floating_point()
                 for n, t in zip(ctx.needs_input_grad[2:], inputs)]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
            outs = ctx.ref(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cts) if c is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                         allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None, *(next(grads) if n else None for n in needs))


# ---------------------------------------------------------------- tree_apply
def bucket_count(tree) -> int:
    """The dispatches :func:`tree_apply` makes over trees shaped and typed
    as ``tree`` (every input and output leaf of one dtype): one for the
    leaves below :data:`OWN_BUCKET` elements together, one for each leaf
    of that size or more."""
    leaves = tree_flatten(tree)[0]
    big = sum(leaf.numel() >= OWN_BUCKET for leaf in leaves)
    return big + (big < len(leaves))


def tree_apply(name: str, *trees, scalars: Sequence = (), like=None):
    """Bucketed whole-tree executor for a fused op.

    Leaves are grouped into buckets by their (input dtypes, output dtypes)
    signature; each bucket is raveled into one contiguous 1-D buffer per
    input, dispatched ONCE, and split back into the trees' shapes.  A leaf
    of :data:`OWN_BUCKET` elements or more forms a bucket of its own, whose
    input buffers are ``reshape(-1)`` views of the leaves: a whole-tree op
    over a full-width model copies no embedding (a 233 M-element leaf a
    node at Qwen2-VL-2B's width).
    ``like`` (single-output ops) is a tree whose leaf dtypes override the
    output-dtype rule.  Returns one tree, or a tuple for multi-output ops.
    """
    op = get(name)
    if not op.elementwise:
        raise ValueError(f"{name} is a shaped op: dispatch it with call()")
    if len(trees) != op.n_inputs:
        raise ValueError(f"{name}: expected {op.n_inputs} trees, got {len(trees)}")
    if len(scalars) != op.n_scalars:
        raise ValueError(
            f"{name}: expected {op.n_scalars} scalars, got {len(scalars)}"
        )
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    for _, d in flat[1:]:
        if d != treedef:
            raise ValueError(f"{name}: input tree structures differ ({d} vs {treedef})")
    leaves = [ls for ls, _ in flat]
    n_leaves = len(leaves[0])
    for i in range(n_leaves):
        shapes = {tuple(leaves[t][i].shape) for t in range(op.n_inputs)}
        if len(shapes) > 1:
            raise ValueError(f"{name}: leaf {i} shapes differ: {sorted(shapes)}")
    like_leaves = None
    if like is not None:
        if op.n_outputs != 1:
            raise ValueError(f"{name}: like= only supported for 1-output ops")
        like_leaves, like_def = tree_flatten(like)
        if like_def != treedef:
            raise ValueError(f"{name}: like= tree structure differs from inputs")
    scalars = tuple(_fp32(s) for s in scalars)

    def out_dtypes_of(i):
        if like_leaves is not None:
            return (like_leaves[i].dtype,)
        return tuple(leaves[j][i].dtype for j in op.out_dtype_from)

    buckets: Dict[Tuple, list] = {}
    for i in range(n_leaves):
        key = (
            tuple(leaves[t][i].dtype for t in range(op.n_inputs)),
            out_dtypes_of(i),
        )
        if leaves[0][i].numel() >= OWN_BUCKET:
            key += (i,)   # a bucket of its own: its inputs pass as views
        buckets.setdefault(key, []).append(i)

    out_leaves = [[None] * n_leaves for _ in range(op.n_outputs)]
    for key, idxs in buckets.items():
        out_dts = key[1]
        sizes = [leaves[0][i].numel() for i in idxs]
        if sum(sizes) == 0:   # bucket of empty leaves: nothing to launch
            for i in idxs:
                for j, d in enumerate(out_dts):
                    out_leaves[j][i] = torch.zeros(
                        leaves[0][i].shape, dtype=d, device=leaves[0][i].device
                    )
            continue

        def cat(t):
            parts = [leaves[t][i].reshape(-1) for i in idxs]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        bufs = tuple(cat(t) for t in range(op.n_inputs))
        if _needs_grad(bufs):   # the default binds this bucket's dtypes for the backward
            outs = _RefGrad.apply(lambda *b, d=out_dts: _flat_dispatch(op, scalars, b, d),
                                  lambda *b, d=out_dts: _flat_ref(op, scalars, b, d), *bufs)
        else:
            outs = _flat_dispatch(op, scalars, bufs, out_dts)
        off = 0
        for i, sz in zip(idxs, sizes):
            for j in range(op.n_outputs):
                out_leaves[j][i] = outs[j][off : off + sz].view(leaves[0][i].shape)
            off += sz

    res = tuple(tree_unflatten(treedef, out_leaves[j]) for j in range(op.n_outputs))
    return res[0] if op.n_outputs == 1 else res


def call(name: str, *tensors, scalars: Sequence = (), **kw):
    """Dispatch a registered op (the reference's ``api.call``).

    Elementwise ops hand over to :func:`tree_apply` (``scalars=`` carries
    their scalar operands), so trees and single tensors both work.  Shaped
    ops, ``call("top_k_unpack", idx, vals, d=777)``, take tensors and their
    static keyword arguments: one dispatch, and on CUDA one launch, per call.
    Differentiable: the backward is the plain version's gradient.
    """
    op = get(name)
    if op.elementwise:
        return tree_apply(name, *tensors, scalars=scalars, **kw)
    if scalars:
        raise ValueError(f"{name}: shaped ops take static keywords, not scalars=")
    if len(tensors) != op.n_inputs:
        raise ValueError(f"{name}: expected {op.n_inputs} tensors, got {len(tensors)}")
    if _needs_grad(tensors):
        return _RefGrad.apply(lambda *t: _shaped_dispatch(op, t, kw),
                              lambda *t: op.ref_fn(*t, **kw), *tensors)
    return _shaped_dispatch(op, tensors, kw)


# --------------------------------------------------- algorithm-layer helpers
def tree_mvr_update(g_new: Tree, v: Tree, g_old: Tree, alpha) -> Tree:
    """Whole-tree MVR direction update: v <- g_new + (1 - alpha)(v - g_old)."""
    return tree_apply("mvr_update", g_new, v, g_old, scalars=(alpha,))


def tree_axpby(a, x: Tree, b, y: Tree, like: Optional[Tree] = None) -> Tree:
    """Whole-tree a*x + b*y (out dtype: y's, or ``like``'s)."""
    return tree_apply("axpby", x, y, scalars=(a, b), like=like)


def tree_add_sub(a: Tree, b: Tree, c: Tree) -> Tree:
    """Whole-tree a + b - c (the gradient-tracking correction)."""
    return tree_apply("add_sub", a, b, c)


def tree_dse_combine(params: Tree, v: Tree, x_ref: Tree, z: Tree, gamma):
    """Fused dual-slow combine, fused-z form: ``h = x_ref - (params - gamma*v)``
    and ``u = z + h`` in one pass.  Returns ``(u, h)``."""
    return tree_apply("dse_combine", params, v, x_ref, z, scalars=(gamma,))


def tree_dse_combine_yh(params: Tree, v: Tree, x_ref: Tree, y: Tree, h_prev: Tree, gamma):
    """Fused dual-slow combine, (y, h_prev) form: the same ``h`` and
    ``u = y + h - h_prev`` in one pass.  Returns ``(u, h)``."""
    return tree_apply("dse_combine_yh", params, v, x_ref, y, h_prev, scalars=(gamma,))
