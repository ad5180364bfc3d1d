"""First-order (paraxial) optics: the ABCD transfer-matrix toolbox.

PyTorch counterpart of ``torchoptics_tpu.ops.abcd``. The chains are tiny
(at most about a dozen surfaces); the 2x2 products are written out
elementwise so they run in exact float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import (
    Lens, Structure, mask_gather, mask_scatter)


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


def compute_last_curvature(structure: Structure, c: torch.Tensor, t: torch.Tensor,
                           nd: torch.Tensor) -> torch.Tensor:
    """Solve the last optical curvature so each system has EFL == 1.

    Algebraic inversion of the system ABCD: with the last refracting
    interface excluded, c_last = -(1 + n·C) / (A·(n - 1)) where n is the
    index before that interface; systems whose last two gaps are both air
    solve at the second-to-last surface instead.

    Args:
      structure: static topology.
      c: flat curvatures *excluding* each system's last curvature (packed
        row-major over ``mask`` minus that slot).
      t: flat thicknesses over ``mask``.
      nd: flat d-line indices over ``mask_G``.

    Returns:
      Flat curvatures over ``mask`` with the solved curvature spliced in.
    """
    mask = structure.mask
    rows = np.arange(mask.shape[0])
    seq_length = structure.n_surfaces
    # A trailing air-air gap puts the last optical curvature one surface
    # earlier.
    air_air = ~structure.mask_G[rows, seq_length - 2]
    last_c_idx = seq_length - 1 - air_air.astype(np.int64)

    c_mask = mask.copy()
    c_mask[rows, seq_length - 1] = False
    c2d = mask_scatter(c_mask, c, 0.0)
    t2d = mask_scatter(mask, t, 0.0)
    n2d = _with_air(mask_scatter(structure.mask_G, nd, 1.0))

    # Exclude the solved-for surface itself from the ABCD product.
    selection = c_mask.copy()
    selection[rows, last_c_idx] = False
    abcd = interface_propagation_abcd(c2d, t2d, n2d)
    eye = torch.eye(2, dtype=abcd.dtype, device=abcd.device)
    abcd = torch.where(torch.as_tensor(selection, device=abcd.device)[..., None, None],
                       abcd, eye)
    abcd = reduce_abcd(abcd)

    index = (torch.as_tensor(rows, device=c2d.device),
             torch.as_tensor(last_c_idx, device=c2d.device))
    last_n = n2d[index]  # index *before* the last interface
    last_c = -(1.0 + last_n * abcd[:, 1, 0]) / (abcd[:, 0, 0] * (last_n - 1.0))
    return mask_gather(mask, c2d.index_put(index, last_c))


def get_paraxial_heights_at_image_plane(specs, lens: Lens, relative_fields) -> torch.Tensor:
    """Paraxial chief-ray heights at the image plane, (B, F): tan(field
    angle) times B' = B - A · (entrance-pupil position) of the system ABCD."""
    rel = torch.as_tensor(np.asarray(relative_fields), dtype=lens.dtype, device=lens.device)
    angles = rel[None, :] * specs.hfov[:, None]
    pupil_position = compute_pupil_position(lens)
    abcd = reduce_abcd(interface_propagation_abcd(lens.c, lens.t, _with_air(lens.nd)))
    a, b = abcd[:, 0, 0], abcd[:, 0, 1]
    b_prime = b - a * pupil_position
    return torch.tan(angles) * b_prime[:, None]
