"""Carry lens parameters across from the JAX package.

``lens_from_numpy`` and ``specs_from_numpy`` build the port's ``Lens`` and
``Specs`` from parameters given as numpy arrays, e.g.
``np.asarray(jax_lens.c)``, so that both packages compute on the same
numbers. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a), device=device)


def lens_from_numpy(stop_idx: Sequence[int], sequence: Sequence[str], c, t, nd,
                    v, device=None) -> Lens:
    """Port spherical ``Lens`` from padded (B, S) or flat parameter arrays;
    the arrays keep their dtype."""
    return Lens(Structure(tuple(stop_idx), tuple(sequence)),
                _tensor(c, device), _tensor(t, device), _tensor(nd, device),
                _tensor(v, device))


def specs_from_numpy(stop_idx: Sequence[int], sequence: Sequence[str], epd,
                     hfov, vig_up=None, vig_down=None, vig_x=None,
                     device=None) -> Specs:
    """Port ``Specs`` from (B,) arrays; ``hfov`` is in radians."""
    return Specs(Structure(tuple(stop_idx), tuple(sequence)),
                 _tensor(epd, device), _tensor(hfov, device),
                 _tensor(vig_up, device), _tensor(vig_down, device),
                 _tensor(vig_x, device))
