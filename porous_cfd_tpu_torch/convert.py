"""Carry weights between a flax parameter tree and a port module.

A flax tree is given as nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``). Every ``nn.Linear`` of the
module at path ``a.b.linear_i`` takes ``tree["a"]["b"]["linear_i"]``: its
``kernel`` (in, out) transposed into ``weight`` (out, in), and its ``bias``.
A missing key, a key the module does not have, or a wrong shape raises.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _linears(module: nn.Module) -> dict[str, nn.Linear]:
    return {name: m for name, m in module.named_modules()
            if isinstance(m, nn.Linear)}


def _leaf_paths(tree: Mapping, prefix: tuple = ()) -> set[tuple]:
    out = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, prefix + (k,))
        else:
            out.add(prefix + (k,))
    return out


def params_from_flax(tree: Mapping[str, Any], module: nn.Module) -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place; returns it."""
    used = set()
    with torch.no_grad():
        for name, lin in _linears(module).items():
            path = tuple(name.split("."))
            node = tree
            for k in path:
                if not isinstance(node, Mapping) or k not in node:
                    raise KeyError(f"flax tree has no entry {'/'.join(path)}")
                node = node[k]
            for leaf, param, transpose in (("kernel", lin.weight, True),
                                           ("bias", lin.bias, False)):
                if leaf not in node:
                    raise KeyError(f"flax tree has no entry {'/'.join(path)}/{leaf}")
                value = np.asarray(node[leaf], np.float32)
                if transpose:
                    value = value.T
                if tuple(value.shape) != tuple(param.shape):
                    raise ValueError(
                        f"{'/'.join(path)}/{leaf}: shape {np.shape(node[leaf])} "
                        f"does not fit the module's {tuple(param.shape)}"
                        + (" (transposed)" if transpose else ""))
                param.copy_(torch.from_numpy(np.array(value, np.float32)))
                used.add(path + (leaf,))
    extra = _leaf_paths(tree) - used
    if extra:
        raise KeyError("flax tree entries with no place in the module: "
                       + ", ".join("/".join(p) for p in sorted(extra)))
    return module


def params_to_flax(module: nn.Module) -> dict:
    """The module's weights as a flax parameter tree of numpy arrays."""
    tree: dict = {}
    for name, lin in _linears(module).items():
        node = tree
        for k in name.split("."):
            node = node.setdefault(k, {})
        node["kernel"] = lin.weight.detach().cpu().numpy().T.copy()
        node["bias"] = lin.bias.detach().cpu().numpy().copy()
    return tree
