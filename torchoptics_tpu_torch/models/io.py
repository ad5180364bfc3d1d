"""Lens prescription I/O: the reference's YAML schema, load and save.

PyTorch counterpart of ``torchoptics_tpu.models.io``. A prescription is a
dict (``zoo``'s schema: ``stop_idx``, ``sequence``, ``hfov`` in degrees,
``epd`` or ``f_number``, ``c``, ``t``, ``nd``, ``v``, optionally ``kappa``
and ``asph``) or a YAML file of one. ``yaml`` is imported only to read or
write a file, so dict prescriptions need no ``pyyaml``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models import zoo
from torchoptics_tpu_torch.models.structure import Lens, Specs


def load_prescription(path_or_dict) -> dict:
    """A prescription from a YAML file path, or a dict passed through."""
    if isinstance(path_or_dict, dict):
        return path_or_dict
    import yaml
    with open(path_or_dict, "r") as f:
        return yaml.safe_load(f)


def load_lens(path_or_dict, device="cuda", dtype=torch.float32) -> Tuple[Specs, Lens]:
    """(Specs, Lens) on ``device`` from a YAML prescription or a dict."""
    return zoo.build(load_prescription(path_or_dict), device=device, dtype=dtype)


def _floats(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def prescription_from_lens(specs: Specs, lens: Lens, f_number: Optional[float] = None) -> dict:
    """Serialize a (Specs, Lens) pair back to the prescription schema."""
    st = lens.structure
    out = {
        "stop_idx": [int(i) for i in st.stop_idx],
        "sequence": list(st.sequence),
        "hfov": [float(v) for v in np.rad2deg(_floats(specs.hfov))],
        "epd": [float(v) for v in _floats(specs.epd)],
        "c": [float(v) for v in _floats(lens.flat_c)],
        "t": [float(v) for v in _floats(lens.flat_t)],
        "nd": [float(v) for v in _floats(lens.flat_nd)],
        "v": [float(v) for v in _floats(lens.flat_v)],
    }
    if f_number is not None:
        out["f_number"] = [float(f_number)]
    if lens.kappa is not None:
        out["kappa"] = [float(v) for v in _floats(lens.kappa)[st.mask]]
    if lens.asph is not None:
        out["asph"] = _floats(lens.asph).tolist()
    return out


def save_lens(path: str, specs: Specs, lens: Lens, **kw) -> None:
    """Write :func:`prescription_from_lens` to a YAML file."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(prescription_from_lens(specs, lens, **kw), f, sort_keys=False)
