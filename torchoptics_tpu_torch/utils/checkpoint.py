"""Checkpoint and resume for lens-optimization state.

PyTorch counterpart of ``torchoptics_tpu.utils.checkpoint``'s ``save``,
``restore`` and ``load_metadata``, with its on-disk layout: the leaves of a
tree as ``leaf_i`` arrays in an ``.npz`` archive, beside a ``.meta.json``
holding their tree paths and the caller's metadata. The paths are the JAX
package's: ``['c']`` for a dict key (keys sorted), ``.params`` for a named
tuple's field, ``[i]`` for a sequence's item, ``[<flat index i>]`` for a
``Lens`` or ``Specs`` leaf; so a parameter dict saved by either package
restores in the other.

A ``LensOptimizer`` state (``optimize.OptState``) is saved in the layout of
the JAX package's (params, optax's Adam state, step): ``.params/['c']``,
``.opt_state/[0]/.count``, ``.opt_state/[0]/.mu/['c']`` (Adam's first
moments, torch's ``exp_avg``), ``.opt_state/[0]/.nu/['c']`` (``exp_avg_sq``)
and ``.step``; it is restored, as ``LensOptimizer.init_from`` builds one,
into an Adam with the template's settings.
A lens prescription's YAML export lives in ``models.io``.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.optimize import OptState, set_adam_moments

_LENS_FIELDS = ("c", "t", "nd", "v", "kappa", "asph")
_SPECS_FIELDS = ("epd", "hfov", "vig_up", "vig_down", "vig_x")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


#: The JAX package's optimizer state (params, optax's (ScaleByAdamState,
#: EmptyState), step), whose field names are the checkpoint's paths.
_OptTree = collections.namedtuple("OptState", "params opt_state step")
_AdamTree = collections.namedtuple("ScaleByAdamState", "count mu nu")


def _as_tree(state: OptState) -> _OptTree:
    """An ``OptState`` as the JAX package's: Adam's step count and moments
    (zeros before its first step)."""
    adam_state = state.opt_state.state
    first = adam_state.get(next(iter(state.params.values())), {})
    count = int(first["step"]) if "step" in first else 0
    moment = lambda key: {k: adam_state[p][key] if p in adam_state else torch.zeros_like(p)
                          for k, p in state.params.items()}
    adam = _AdamTree(np.int32(count), moment("exp_avg"), moment("exp_avg_sq"))
    return _OptTree(state.params, [adam], np.int32(state.step))


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order and path syntax."""
    join = lambda key: key if not path else f"{path}/{key}"
    if tree is None:
        return
    if isinstance(tree, OptState):
        yield from _flatten(_as_tree(tree), path)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], join(f"[{k!r}]"))
    elif isinstance(tree, (Lens, Specs)):
        fields = _LENS_FIELDS if isinstance(tree, Lens) else _SPECS_FIELDS
        children = [getattr(tree, f) for f in fields]
        for i, child in enumerate(c for c in children if c is not None):
            yield join(f"[<flat index {i}>]"), child
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), join(f".{name}"))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, join(f"[{i}]"))
    else:
        yield path, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save(path: str, tree: Any, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Save a tree of tensors (dicts, lists, tuples, named tuples, ``Lens``,
    ``Specs``, an ``OptState``) to ``path`` (.npz archive + json sidecar)."""
    pairs = list(_flatten(tree))
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(pairs)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    with open(_meta_path(path), "w") as f:
        json.dump({"paths": [p for p, _ in pairs], "metadata": metadata or {}}, f)


def _restore_leaf(value: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(value).to(like.device)
    if isinstance(like, (int, np.integer)):
        return int(value)
    if isinstance(like, (float, np.floating)):
        return float(value)
    return value


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken, in order, from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, OptState):
        tree = _rebuild(_as_tree(like), leaves)
        params = {k: v.detach().clone().requires_grad_(True) for k, v in tree.params.items()}
        adam = torch.optim.Adam(list(params.values()), **like.opt_state.defaults)
        moments = tree.opt_state[0]
        set_adam_moments(adam, params, moments.mu, moments.nu, moments.count)
        return OptState(params, adam, tree.step)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (Lens, Specs)):
        fields = _LENS_FIELDS if isinstance(like, Lens) else _SPECS_FIELDS
        values = {f: _rebuild(getattr(like, f), leaves) for f in fields}
        return type(like)(like.structure, **values)
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), leaves) for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, leaves) for sub in like)
    return _restore_leaf(*next(leaves))


def restore(path: str, like: Any) -> Any:
    """Restore a tree saved with :func:`save` (by either package), using
    ``like`` for the tree structure and the tensors' devices.

    Raises ``ValueError`` when the checkpoint does not match ``like``: a
    leaf-count mismatch, or a tree-path mismatch (read from the
    ``.meta.json`` sidecar), naming the first differing path on each side."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    values = [npz[f"leaf_{i}"] for i in range(len(npz.files))]
    pairs = list(_flatten(like))
    if len(values) != len(pairs):
        raise ValueError(f"checkpoint {path!r} has {len(values)} leaves, but the template has "
                         f"{len(pairs)}; was it saved from a different structure?")
    meta_file = _meta_path(path)
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            saved = json.load(f).get("paths")
        like_paths: List[str] = [p for p, _ in pairs]
        if saved is not None and list(saved) != like_paths:
            s, t = next((s, t) for s, t in zip(saved, like_paths) if s != t)
            raise ValueError(f"checkpoint {path!r} tree structure does not match the "
                             f"template: first differing leaf path is {s!r} (saved) vs "
                             f"{t!r} (template)")
    return _rebuild(like, iter(zip(values, (leaf for _, leaf in pairs))))


def load_metadata(path: str) -> Dict[str, Any]:
    with open(_meta_path(path)) as f:
        return json.load(f)["metadata"]
