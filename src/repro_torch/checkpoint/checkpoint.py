"""Tree checkpointing in the reference's on-disk format.

Counterpart of ``repro.checkpoint.checkpoint``.  A directory per step,
``step_%010d/``, holds ``manifest.msgpack`` (step, leaf paths, dtypes,
shapes, metadata) and ``data.npz`` (the leaves as ``leaf_0``, ``leaf_1``,
...).  Writes are atomic (a temp dir, then a rename), so a crashed save never
corrupts the latest checkpoint.  Each package reads the other's directories.

Leaves are listed in the reference's order under its path strings:
dataclass fields in declaration order (``.params``), dict keys sorted
(``['w1']``), tuple items by position (``[0]``); None holds no leaf, and a
``Packed`` payload's leaves are its ``.data``.  So a DSE-MVR state with a
CHOCO wire lists ``.params/['w1']``, ..., ``.step``,
``.comp/.wire/[0]/['hat']/['w1']``, ..., ``.comp/.key``.  The port's host
step is written as a 0-d int32 leaf, as the reference's step is an int32
array.  Where the reference keeps its codec's PRNG key, the port keeps
``ChannelState.event``: it is written at the key's position and under its
name, as the key's uint32 data of shape (2,) holding ``[0, event]``, so the
reference loads the state with ``like=`` and wraps a key from it.  The
manifest's ``event_keys`` lists those leaves' paths, and only the port
writes it: loading reads the event back from a listed leaf, and from a
reference's key (whose threefry words hold no event count) gives event 0.
Older port directories kept the event as a 0-d int32 leaf ``.comp/.event``;
they still load.  Without ``like`` both kinds of port event come back as
``.comp/.event``.  bfloat16 leaves are written as the
reference writes them, a 2-byte void (``V2``) array of the raw bits with
``bfloat16`` in the manifest's ``dtypes``, and read back as
``torch.bfloat16``.  The
manifest is MessagePack (``_msgpack``); no ``msgpack`` or ``ml_dtypes``
package is needed.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compression.base import ChannelState, Packed
from ..device import resolve_device
from . import _msgpack

Tree = Any

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "CheckpointManager"]

_BF16 = "bfloat16"
_EVENT, _KEY = ".event", ".key"


class _EventKey(int):
    """A ``ChannelState.event`` on its way to disk as the key leaf."""


def _as_key(path: str) -> str:
    """A leaf path with a channel's event leaf named as the key leaf."""
    return path[:-len(_EVENT)] + _KEY if path.endswith(_EVENT) else path


def _to_numpy(v) -> np.ndarray:
    """The array a leaf is stored as: tensors on the host (bf16 as its raw
    bits, viewed as 2-byte voids), host ints as 0-d int32."""
    if isinstance(v, _EventKey):
        return np.array([0, v], np.uint32)
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_)):
        return np.asarray(v, np.int32)
    return np.asarray(v)


def _dtype_name(v, arr: np.ndarray) -> str:
    return _BF16 if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 else str(arr.dtype)


def _flatten_with_paths(tree: Tree, path: str = "", out=None) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's leaf order and path strings."""
    out = [] if out is None else out
    if tree is None:
        return out
    sep = "/" if path else ""
    if isinstance(tree, Packed):
        return _flatten_with_paths(tree.data, f"{path}{sep}.data", out)
    if isinstance(tree, ChannelState):
        _flatten_with_paths(tree.wire, f"{path}{sep}.wire", out)
        out.append((f"{path}{sep}{_KEY}", _EventKey(tree.event)))
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_paths(tree[k], f"{path}{sep}[{k!r}]", out)
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            _flatten_with_paths(item, f"{path}{sep}[{i}]", out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten_with_paths(getattr(tree, f.name), f"{path}{sep}.{f.name}", out)
    else:
        out.append((path, tree))
    return out


def _rebuild(like: Tree, leaves) -> Tree:
    """``like`` with its leaves replaced, in order, from the iterator."""
    if like is None:
        return None
    if isinstance(like, Packed):
        return Packed(_rebuild(like.data, leaves), meta=like.meta, shared=like.shared)
    if isinstance(like, ChannelState):
        wire = _rebuild(like.wire, leaves)
        event = next(leaves)   # a port's event (0-d), or a reference's key data
        return ChannelState(wire=wire, event=int(event) if event.dim() == 0 else 0)
    if isinstance(like, dict):
        rebuilt = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(item, leaves) for item in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves) for f in dataclasses.fields(like)
        })
    leaf = next(leaves)
    return int(leaf) if isinstance(like, int) else leaf


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def save_checkpoint(directory: str, step: int, tree: Tree, metadata: Optional[Dict] = None) -> str:
    """Write ``tree`` (tensors on any device, numpy arrays, host ints, in
    dicts, tuples and dataclasses) as ``step_%010d`` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(tree)
    leaves = [_to_numpy(v) for _, v in flat]
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        manifest = {
            "step": step,
            "paths": [p for p, _ in flat],
            "dtypes": [_dtype_name(v, a) for (_, v), a in zip(flat, leaves)],
            "shapes": [list(a.shape) for a in leaves],
            "metadata": metadata or {},
        }
        events = [p for p, v in flat if isinstance(v, _EventKey)]
        if events:
            manifest["event_keys"] = events
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(_msgpack.packb(manifest))
        np.savez(os.path.join(tmp, "data.npz"), **{f"leaf_{i}": a for i, a in enumerate(leaves)})
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def load_checkpoint(directory: str, step: Optional[int] = None, like: Optional[Tree] = None,
                    *, device=None):
    """Returns ``(tree, metadata)``, the leaves as tensors on ``device``
    (CUDA unless the CPU is asked for), bfloat16 ones as ``torch.bfloat16``.

    With ``like`` (a port tree of the saved layout) the result has its
    structure, and its host ints come back as ints; the leaf paths must
    match.  Without it the result is the reference's nested dict keyed by
    path segment (``{".params": {"w1": ...}, ".step": ..., ".comp":
    {".wire": {"0": ...}}}``); ``repro_torch.convert.state_from_checkpoint``
    turns such a dict into an algorithm state."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    paths = list(manifest["paths"])
    events = {paths.index(p) for p in manifest.get("event_keys", ())}
    with np.load(os.path.join(path, "data.npz")) as data:
        leaves = [_from_numpy(data[f"leaf_{i}"], dt, dev) if i not in events
                  else torch.tensor(int(data[f"leaf_{i}"][1]), dtype=torch.int32, device=dev)
                  for i, dt in enumerate(manifest["dtypes"])]
    for i in events:   # the port's event leaves come back 0-d under .event
        paths[i] = paths[i][:-len(_KEY)] + _EVENT
    if like is not None:
        like_paths = [p for p, _ in _flatten_with_paths(like)]
        want, have = [_as_key(p) for p in like_paths], [_as_key(p) for p in paths]
        if want != have:
            i = next((i for i, (a, b) in enumerate(zip(want, have)) if a != b),
                     min(len(like_paths), len(paths)))
            raise ValueError(
                f"checkpoint at {path} has {len(paths)} leaves and `like` has "
                f"{len(like_paths)}; leaf {i} differs (`like` "
                f"{like_paths[i] if i < len(like_paths) else None!r}, checkpoint "
                f"{paths[i] if i < len(paths) else None!r}): load without `like` and "
                "convert by path (repro_torch.convert.state_from_checkpoint)"
            )
        return _rebuild(like, iter(leaves)), manifest["metadata"]
    out: Dict[str, Any] = {}
    for p, leaf in zip(paths, leaves):
        cur = out
        parts = [seg for seg in p.replace("[", "/").replace("]", "").replace("'", "").split("/")
                 if seg]
        for seg in parts[:-1]:
            cur = cur.setdefault(seg, {})
        cur[parts[-1]] = leaf
    return out, manifest["metadata"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


class CheckpointManager:
    """Keeps the newest ``keep`` checkpoints in a directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree: Tree, metadata: Optional[Dict] = None):
        path = save_checkpoint(self.directory, step, tree, metadata)
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_")
        )
        for old in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{old:010d}"), ignore_errors=True)
        return path

    def restore(self, like: Optional[Tree] = None, step: Optional[int] = None, *, device=None):
        return load_checkpoint(self.directory, step, like, device=device)
