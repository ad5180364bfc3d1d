"""Lens topology, specifications, and lens parameters as tensor dataclasses.

PyTorch counterpart of ``torchoptics_tpu.models.structure``:

* ``Structure`` is static metadata (hashable, host-side numpy masks), the
  same class as in the JAX package.
* ``Specs`` and ``Lens`` are dataclasses of tensors on one explicit device.
  Updates are functional (``replace`` returns a new object); scatters use
  static ``np.nonzero`` indices.

Tensor layout convention (shared with the trace engine):

    dim 0: n_lens systems, dim 1: fields, dim 2: pupil rays,
    dim 3: wavelengths, dim 4: surfaces (when present).

Padded 2-D parameter tensors have shape ``(n_systems, max_surfaces)``;
curvatures/thicknesses pad with 0, refractive indices with 1, Abbe numbers
with 1 (a finite pad on purpose: a NaN pad poisons gradients through masked
lanes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch


def _as_seq_tuple(sequence) -> Tuple[str, ...]:
    if isinstance(sequence, str):
        return (sequence,)
    if isinstance(sequence, np.ndarray):
        return tuple(str(s) for s in sequence.reshape(-1))
    return tuple(str(s) for s in sequence)


def _as_int_tuple(x) -> Tuple[int, ...]:
    if isinstance(x, (int, np.integer)):
        return (int(x),)
    return tuple(int(v) for v in np.asarray(x).reshape(-1))


def mask_scatter(mask: np.ndarray, flat: torch.Tensor, fill) -> torch.Tensor:
    """Scatter 1-D ``flat`` values into the True positions of a static 2-D
    boolean ``mask`` (row-major), padding the rest with ``fill``."""
    rows, cols = np.nonzero(mask)
    out = torch.full(mask.shape, fill, dtype=flat.dtype, device=flat.device)
    index = (torch.as_tensor(rows, device=flat.device),
             torch.as_tensor(cols, device=flat.device))
    return out.index_put(index, flat)


def mask_gather(mask: np.ndarray, padded: torch.Tensor) -> torch.Tensor:
    """Gather the True positions of a static mask out of a padded 2-D tensor
    (row-major)."""
    rows, cols = np.nonzero(mask)
    return padded[torch.as_tensor(rows, device=padded.device),
                  torch.as_tensor(cols, device=padded.device)]


@dataclass(frozen=True)
class Structure:
    """Batched lens topology: where the glass is and where the stop sits.

    ``sequence`` strings use the G/A alphabet: 'G' = glass gap after the
    surface, 'A' = air gap. One character per surface. ``stop_idx[i]`` is the
    index of the aperture-stop surface of system ``i``. Hashable and
    immutable; all masks are host-side numpy.
    """

    stop_idx: Tuple[int, ...]
    sequence: Tuple[str, ...]
    pad_to: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "stop_idx", _as_int_tuple(self.stop_idx))
        object.__setattr__(self, "sequence", _as_seq_tuple(self.sequence))
        if len(self.stop_idx) != len(self.sequence):
            raise ValueError("stop_idx and sequence must have the same batch size")
        width = max((len(s) for s in self.sequence), default=0)
        if self.pad_to is None:
            object.__setattr__(self, "pad_to", width)
        elif self.pad_to < width:
            raise ValueError(f"pad_to={self.pad_to} is below the widest sequence {width}")

    @cached_property
    def mask(self) -> np.ndarray:
        """(B, S) bool: valid (non-padding) surfaces."""
        m = np.zeros((len(self), self.pad_to), dtype=bool)
        for i, s in enumerate(self.sequence):
            m[i, : len(s)] = True
        return m

    @cached_property
    def mask_G(self) -> np.ndarray:
        """(B, S) bool: surfaces followed by a glass gap."""
        m = np.zeros((len(self), self.pad_to), dtype=bool)
        for i, s in enumerate(self.sequence):
            for j, ch in enumerate(s):
                m[i, j] = ch == "G"
        return m

    @cached_property
    def n_surfaces(self) -> np.ndarray:
        return self.mask.sum(axis=1)

    @cached_property
    def last_g_idx(self) -> np.ndarray:
        """Index of the last glass gap per system."""
        idx = np.broadcast_to(np.arange(self.mask.shape[1]), self.mask.shape)
        return np.where(self.mask_G, idx, 0).argmax(axis=1)

    @cached_property
    def mask_except_last(self) -> np.ndarray:
        """Valid-surface mask with the surface after the last glass zeroed."""
        m = self.mask.copy()
        idx = np.minimum(self.last_g_idx + 1, self.mask.shape[1] - 1)
        m[np.arange(len(self)), idx] = False
        return m

    def __len__(self) -> int:
        return len(self.sequence)

    def __hash__(self):
        return hash((self.stop_idx, self.sequence, self.pad_to))

    def up_to_stop(self) -> "Structure":
        """Topology truncated at the aperture stop; the truncated width is the
        largest stop index across the batch."""
        max_len = max(self.stop_idx) if self.stop_idx else 0
        seqs = tuple(s[: min(k, len(s))] for s, k in zip(self.sequence, self.stop_idx))
        return Structure(self.stop_idx, seqs, pad_to=max_len)

    def __getitem__(self, index) -> "Structure":
        """The systems at ``index`` (an int, a slice or a host-side array of
        rows), padded to the widest of them."""
        rows = _rows(index, len(self))
        return Structure(tuple(self.stop_idx[i] for i in rows),
                         tuple(self.sequence[i] for i in rows))


def _rows(index, n: int) -> list:
    """System rows selected by an int, a slice or a host-side index array."""
    if isinstance(index, (int, np.integer)):
        index = slice(int(index), int(index) + 1)
    if isinstance(index, slice):
        return list(range(n)[index])
    return [int(i) for i in np.asarray(index).reshape(-1)]


def find_valid_curvatures(structure: Structure) -> np.ndarray:
    """Mask of optimizable curvatures: excludes air-air interfaces and the
    last curvature (solved analytically)."""
    mask_G = structure.mask_G
    previous = np.concatenate((np.zeros_like(mask_G[:, 0:1]), mask_G[:, :-1]), axis=1)
    return (mask_G | previous) & structure.mask_except_last & structure.mask


def _as_param(values, device, dtype) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values if device is None else values.to(device)
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)


def _pad2d(values: torch.Tensor, mask: np.ndarray, fill) -> torch.Tensor:
    if values.ndim == 1:
        return mask_scatter(mask, values, fill)
    if tuple(values.shape) != mask.shape:
        raise ValueError(
            f"padded parameter shape {tuple(values.shape)} != mask shape {mask.shape}")
    return values


def _mask_tensor(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mask, device=like.device)


@dataclass
class Specs:
    """Lens specifications: entrance pupil diameter, half field of view
    [radians] and the vignetting factors, each (B,)."""

    structure: Structure
    epd: torch.Tensor
    hfov: torch.Tensor
    vig_up: Optional[torch.Tensor] = None
    vig_down: Optional[torch.Tensor] = None
    vig_x: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.epd = _as_param(self.epd, None, torch.float32)
        self.hfov = _as_param(self.hfov, self.epd.device, self.epd.dtype)
        for name in ("vig_up", "vig_down", "vig_x"):
            v = getattr(self, name)
            setattr(self, name, torch.zeros_like(self.epd) if v is None
                    else _as_param(v, self.epd.device, self.epd.dtype))

    @property
    def device(self) -> torch.device:
        return self.epd.device

    def __len__(self):
        return len(self.structure)

    def replace(self, **kw) -> "Specs":
        return dataclasses.replace(self, **kw)

    def scale(self, factor) -> "Specs":
        """Scale the entrance pupil diameter (the only length) by ``factor``."""
        return self.replace(epd=self.epd * factor)

    def up_to_stop(self) -> "Specs":
        return self.replace(structure=self.structure.up_to_stop())

    def __getitem__(self, index) -> "Specs":
        """The systems at ``index`` (see ``Structure.__getitem__``)."""
        rows = torch.as_tensor(_rows(index, len(self)), device=self.device)
        return Specs(self.structure[index], self.epd[rows], self.hfov[rows],
                     self.vig_up[rows], self.vig_down[rows], self.vig_x[rows])

    def detach(self) -> "Specs":
        return self.to(detach=True)

    def to(self, device=None, dtype=None, detach: bool = False) -> "Specs":
        def move(a):
            a = a.detach() if detach else a
            return a.to(device=device, dtype=dtype)
        return Specs(self.structure, move(self.epd), move(self.hfov),
                     move(self.vig_up), move(self.vig_down), move(self.vig_x))


@dataclass
class Lens:
    """Batched lens parameters.

    ``c``/``t`` are (B, S) padded with 0; ``nd``/``v`` padded with 1. 1-D
    compact ("flat") forms are accepted by the constructor and promoted.
    ``kappa`` (B, S) conic constants and ``asph`` (B, S, K) even-asphere
    coefficients are held as data; ``None`` means purely spherical, the only
    kind the port's trace engines take so far.
    """

    structure: Structure
    c: torch.Tensor
    t: torch.Tensor
    nd: torch.Tensor
    v: torch.Tensor
    kappa: Optional[torch.Tensor] = None
    asph: Optional[torch.Tensor] = None

    def __post_init__(self):
        st = self.structure
        self.c = _pad2d(_as_param(self.c, None, torch.float32), st.mask, 0.0)
        dev, dt = self.c.device, self.c.dtype
        self.t = _pad2d(_as_param(self.t, dev, dt), st.mask, 0.0)
        self.nd = _pad2d(_as_param(self.nd, dev, dt), st.mask_G, 1.0)
        self.v = _pad2d(_as_param(self.v, dev, dt), st.mask_G, 1.0)
        if self.kappa is not None:
            self.kappa = _pad2d(_as_param(self.kappa, dev, dt), st.mask, 0.0)
        if self.asph is not None:
            self.asph = _as_param(self.asph, dev, dt)
            if self.asph.ndim != 3 or tuple(self.asph.shape[:2]) != st.mask.shape:
                raise ValueError(f"asph must be (B, S, K), got {tuple(self.asph.shape)}")

    def __len__(self):
        return len(self.structure)

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    @property
    def device(self) -> torch.device:
        return self.c.device

    @property
    def is_spherical(self) -> bool:
        """True when the closed-form sphere intersection applies."""
        return self.kappa is None and self.asph is None

    def replace(self, **kw) -> "Lens":
        return dataclasses.replace(self, **kw)

    def scale(self, factor) -> "Lens":
        """Scale all lengths by ``factor`` (a scalar or one per system).
        The asphere coefficient of r^(2k+4) scales by factor^-(2k+3)."""
        factor = torch.as_tensor(factor, dtype=self.dtype, device=self.device)
        f = factor.reshape(-1, 1) if factor.ndim else factor
        asph = None
        if self.asph is not None:
            k = torch.arange(self.asph.shape[-1], dtype=self.dtype, device=self.device)
            fa = factor.reshape(-1, 1, 1) if factor.ndim else factor
            asph = self.asph * fa ** -(2.0 * k + 3.0)
        return Lens(self.structure, self.c / f, self.t * f, self.nd, self.v,
                    kappa=self.kappa, asph=asph)

    @property
    def flat_c(self) -> torch.Tensor:
        return mask_gather(self.structure.mask, self.c)

    @property
    def flat_t(self) -> torch.Tensor:
        return mask_gather(self.structure.mask, self.t)

    @property
    def flat_nd(self) -> torch.Tensor:
        return mask_gather(self.structure.mask_G, self.nd)

    @property
    def flat_v(self) -> torch.Tensor:
        return mask_gather(self.structure.mask_G, self.v)

    @property
    def flat_c_but_last(self) -> torch.Tensor:
        """All valid curvatures except the last one of each system."""
        m = self.structure.mask.copy()
        m[np.arange(len(self)), self.structure.n_surfaces - 1] = False
        return mask_gather(m, self.c)

    def with_flat_c(self, c) -> "Lens":
        return self.replace(c=mask_scatter(self.structure.mask, c, 0.0))

    def with_flat_t(self, t) -> "Lens":
        return self.replace(t=mask_scatter(self.structure.mask, t, 0.0))

    def with_flat_nd(self, nd) -> "Lens":
        return self.replace(nd=mask_scatter(self.structure.mask_G, nd, 1.0))

    def with_flat_v(self, v) -> "Lens":
        return self.replace(v=mask_scatter(self.structure.mask_G, v, 1.0))

    def detach(self) -> "Lens":
        return self.to(detach=True)

    def to(self, device=None, dtype=None, detach: bool = False) -> "Lens":
        def move(a):
            if a is None:
                return None
            a = a.detach() if detach else a
            return a.to(device=device, dtype=dtype)
        return Lens(self.structure, move(self.c), move(self.t), move(self.nd),
                    move(self.v), kappa=move(self.kappa), asph=move(self.asph))

    def up_to_stop(self) -> "Lens":
        st = self.structure.up_to_stop()
        w = st.pad_to
        m = _mask_tensor(st.mask, self.c)
        mg = _mask_tensor(st.mask_G, self.c)
        kappa = None if self.kappa is None else torch.where(m, self.kappa[:, :w], 0.0)
        asph = None if self.asph is None else torch.where(m[..., None], self.asph[:, :w], 0.0)
        return Lens(st, torch.where(m, self.c[:, :w], 0.0),
                    torch.where(m, self.t[:, :w], 0.0),
                    torch.where(mg, self.nd[:, :w], 1.0),
                    torch.where(mg, self.v[:, :w], 1.0), kappa=kappa, asph=asph)

    def __getitem__(self, index) -> "Lens":
        """The systems at ``index`` (see ``Structure.__getitem__``), cut to
        their own widest sequence."""
        st = self.structure[index]
        rows = torch.as_tensor(_rows(index, len(self)), device=self.device)
        w = st.pad_to
        pick = lambda a: None if a is None else a[rows, :w]
        return Lens(st, pick(self.c), pick(self.t), pick(self.nd), pick(self.v),
                    kappa=pick(self.kappa), asph=pick(self.asph))

    def get_refractive_indices(self, wavelengths) -> torch.Tensor:
        """n(λ) per surface gap, shape (B, S, W). See glass.refractive_indices."""
        from torchoptics_tpu_torch.models import glass
        return glass.refractive_indices(self.nd, self.v, self.structure.mask_G,
                                        wavelengths)

    @property
    def efl(self) -> torch.Tensor:
        from torchoptics_tpu_torch.ops import abcd
        return abcd.get_first_order(self)[0]

    @property
    def bfl(self) -> torch.Tensor:
        from torchoptics_tpu_torch.ops import abcd
        return abcd.get_first_order(self)[1]
