"""First-order (paraxial) optics: the ABCD transfer-matrix toolbox.

PyTorch counterpart of ``torchoptics_tpu.ops.abcd``. The chains are tiny
(at most about a dozen surfaces); the 2x2 products are written out
elementwise so they run in exact float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens


def _matmul2x2(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched exact 2x2 matrix product via elementwise ops."""
    a = lhs[..., 0, 0] * rhs[..., 0, 0] + lhs[..., 0, 1] * rhs[..., 1, 0]
    b = lhs[..., 0, 0] * rhs[..., 0, 1] + lhs[..., 0, 1] * rhs[..., 1, 1]
    c = lhs[..., 1, 0] * rhs[..., 0, 0] + lhs[..., 1, 1] * rhs[..., 1, 0]
    d = lhs[..., 1, 0] * rhs[..., 0, 1] + lhs[..., 1, 1] * rhs[..., 1, 1]
    return torch.stack((torch.stack((a, b), dim=-1), torch.stack((c, d), dim=-1)),
                       dim=-2)


def reduce_abcd(abcd: torch.Tensor) -> torch.Tensor:
    """Compose a chain of 2x2 ray-transfer matrices, last surface leftmost:
    (B, S, 2, 2) -> (B, 2, 2) computing M_{S-1} @ ... @ M_0 with the same
    pairwise reduction order as the JAX package."""
    while abcd.shape[1] > 1:
        if abcd.shape[1] % 2 == 0:
            abcd = _matmul2x2(abcd[:, 1::2], abcd[:, ::2])
        else:
            abcd = torch.cat((_matmul2x2(abcd[:, 1::2], abcd[:, :-1:2]),
                              abcd[:, -1:]), dim=1)
    return abcd.squeeze(1)


def interface_propagation_abcd(c: torch.Tensor, t: torch.Tensor,
                               n: torch.Tensor) -> torch.Tensor:
    """ABCD matrix of a spherical refraction followed by a translation.

    Args:
      c, t: (B, S) curvatures and thicknesses.
      n: (B, S+1) refractive indices, the medium before the first surface
        first.

    Returns:
      (B, S, 2, 2) per-surface matrices [[A, B], [C, D]].
    """
    if not n.shape[-1] - 1 == c.shape[-1] == t.shape[-1]:
        raise ValueError(f"n {tuple(n.shape)} must be one wider than c {tuple(c.shape)}")
    D = n[:, :-1] / n[:, 1:]
    C = c * (D - 1.0)
    A = 1.0 + C * t
    B = D * t
    return torch.stack((A, B, C, D), dim=-1).reshape(n.shape[0], -1, 2, 2)


def _with_air(nd: torch.Tensor) -> torch.Tensor:
    return torch.cat((torch.ones_like(nd[:, 0:1]), nd), dim=1)


def compute_pupil_position(lens: Lens) -> torch.Tensor:
    """Axial position of the paraxial entrance pupil w.r.t. the first
    surface: B/A of everything before the aperture stop. Returns (B,)."""
    sub = lens.up_to_stop()
    if sub.structure.mask.shape[1] == 0:
        return torch.zeros(len(lens), dtype=lens.dtype, device=lens.device)
    abcd = reduce_abcd(interface_propagation_abcd(sub.c, sub.t, _with_air(sub.nd)))
    return abcd[:, 0, 1] / abcd[:, 0, 0]


def get_first_order(lens: Lens) -> Tuple[torch.Tensor, torch.Tensor]:
    """(EFL, BFL) of each system, both (B,): ABCD of the system with the last
    (image-space) thickness zeroed; EFL = -1/C, BFL = -A/C."""
    st = lens.structure
    last = np.zeros(st.mask.shape, dtype=bool)
    last[np.arange(len(lens)), st.n_surfaces - 1] = True
    t = torch.where(torch.as_tensor(last, device=lens.device), 0.0, lens.t)
    abcd = reduce_abcd(interface_propagation_abcd(lens.c, t, _with_air(lens.nd)))
    efl = -1.0 / abcd[:, 1, 0]
    bfl = -abcd[:, 0, 0] / abcd[:, 1, 0]
    return efl, bfl


def compute_magnification(lens: Lens) -> torch.Tensor:
    """First-order magnification = A element of the full system ABCD, (B,)."""
    abcd = reduce_abcd(interface_propagation_abcd(lens.c, lens.t, _with_air(lens.nd)))
    return abcd[:, 0, 0]
