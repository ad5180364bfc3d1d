"""Carry lens parameters and optimizer state across from the JAX package.

``lens_from_numpy`` and ``specs_from_numpy`` build the port's ``Lens`` and
``Specs`` from parameters given as numpy arrays, e.g.
``np.asarray(jax_lens.c)``; ``params_from_numpy`` and ``opt_state_from_numpy``
build the optimizer's parameters and an Adam state from the numpy leaves of a
JAX ``OptState``; ``mlp_params_from_numpy`` the generator network
(``models.generator``) from the JAX example's MLP parameters; so that both
packages compute on the same numbers. Nothing
here imports JAX. Like every entry point of the port, they put the tensors
on the GPU unless the caller names another device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from torchoptics_tpu_torch.models.generator import GeneratorMLP
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a), device=device)


def lens_from_numpy(stop_idx: Sequence[int], sequence: Sequence[str], c, t, nd,
                    v, device="cuda", kappa=None, asph=None) -> Lens:
    """Port ``Lens`` from padded (B, S) or flat parameter arrays, with the
    optional conic constants ``kappa`` (B, S) and even-asphere coefficients
    ``asph`` (B, S, K); the arrays keep their dtype."""
    return Lens(Structure(tuple(stop_idx), tuple(sequence)),
                _tensor(c, device), _tensor(t, device), _tensor(nd, device),
                _tensor(v, device), kappa=_tensor(kappa, device), asph=_tensor(asph, device))


def specs_from_numpy(stop_idx: Sequence[int], sequence: Sequence[str], epd,
                     hfov, vig_up=None, vig_down=None, vig_x=None,
                     device="cuda") -> Specs:
    """Port ``Specs`` from (B,) arrays; ``hfov`` is in radians."""
    return Specs(Structure(tuple(stop_idx), tuple(sequence)),
                 _tensor(epd, device), _tensor(hfov, device),
                 _tensor(vig_up, device), _tensor(vig_down, device),
                 _tensor(vig_x, device))


def params_from_numpy(params: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """The optimizer's parameter dict (``{'c', 't', 'g'}``, plus ``kappa``
    and ``asph`` where present) from numpy arrays."""
    return {k: _tensor(v, device) for k, v in params.items()}


def opt_state_from_numpy(optimizer, params: Dict[str, np.ndarray],
                         mu: Optional[Dict[str, np.ndarray]] = None,
                         nu: Optional[Dict[str, np.ndarray]] = None,
                         count: int = 0, step: int = 0, device="cuda"):
    """A ``LensOptimizer`` state seeded from the numpy leaves of a JAX
    ``OptState``: its params, optax's Adam moments ``mu`` and ``nu``, Adam's
    ``count`` and the optimizer's ``step``."""
    convert = lambda d: None if d is None else params_from_numpy(d, device)
    return optimizer.init_from(params_from_numpy(params, device), convert(mu),
                               convert(nu), int(count), int(step))


def mlp_params_from_numpy(params: Sequence[Dict[str, np.ndarray]], device="cuda"):
    """A ``models.generator.GeneratorMLP`` whose weights are
    JAX's MLP parameters: its list of ``{"w": (din, dout), "b": (dout,)}``
    arrays, as ``examples/train_generator.py``'s ``init_mlp`` builds it."""
    ws = [np.asarray(layer["w"]) for layer in params]
    net = GeneratorMLP([ws[0].shape[0]] + [w.shape[1] for w in ws], device=device)
    with torch.no_grad():
        for i, layer in enumerate(params):
            net.w[i].copy_(_tensor(layer["w"], device))
            net.b[i].copy_(_tensor(layer["b"], device))
    return net
