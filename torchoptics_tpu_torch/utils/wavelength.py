"""Wavelength utilities: the visible-spectrum to RGB map.

PyTorch-side counterpart of ``torchoptics_tpu.utils.wavelength`` (plain
Python; it keeps its own copy): the classic piecewise-linear approximation
(Bruton's algorithm) used to colour spot diagrams.
"""

from __future__ import annotations

from typing import Tuple, Union

from torchoptics_tpu_torch.models.glass import WAVELENGTH_NAMES


def wavelength_to_rgb(wavelength: Union[float, str], gamma: float = 0.8
                      ) -> Tuple[int, int, int]:
    """Approximate RGB (0-255 ints) for a wavelength in nm (380-750 visible)
    or a Fraunhofer line name of ``glass.WAVELENGTH_NAMES`` ("C", "d", "F").

    Out-of-gamut wavelengths fade to black at the spectrum edges; far UV/IR
    return mid-gray so plots remain visible.
    """
    w = float(WAVELENGTH_NAMES.get(wavelength, wavelength))
    if w < 380.0 or w > 750.0:
        return (128, 128, 128)
    if w < 440.0:
        attenuation = 0.3 + 0.7 * (w - 380.0) / (440.0 - 380.0)
        r = ((-(w - 440.0) / (440.0 - 380.0)) * attenuation) ** gamma
        g, b = 0.0, attenuation ** gamma
    elif w < 490.0:
        r = 0.0
        g = ((w - 440.0) / (490.0 - 440.0)) ** gamma
        b = 1.0
    elif w < 510.0:
        r = 0.0
        g = 1.0
        b = ((510.0 - w) / (510.0 - 490.0)) ** gamma
    elif w < 580.0:
        r = ((w - 510.0) / (580.0 - 510.0)) ** gamma
        g = 1.0
        b = 0.0
    elif w < 645.0:
        r = 1.0
        g = ((645.0 - w) / (645.0 - 580.0)) ** gamma
        b = 0.0
    else:
        attenuation = 0.3 + 0.7 * (750.0 - w) / (750.0 - 645.0)
        r = attenuation ** gamma
        g, b = 0.0, 0.0
    return (int(round(255 * r)), int(round(255 * g)), int(round(255 * b)))
