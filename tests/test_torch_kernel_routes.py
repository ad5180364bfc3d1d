"""The specialised CUDA kernels that the launchers route to exist in the
sources.

No CPU can build the kernels, so these tests read the ``.cu`` text: each
launcher's list of routed sizes (P2's ``SPECIALIZED_KW``, K2 backward's
``SHORT_SURF``), the ``switch`` that dispatches on the size, and the
instantiation each ``case`` launches. A size in the list without a ``case``
that launches its own instantiation, or a ``case`` outside the list, fails.
The imaging renders' PSF sizes (256^2 to 2048^2 at BASELINE config 5) and the
zoo populations' surface counts that the port's main paths run must each be
routed to a specialised kernel.
"""

import re
from pathlib import Path

import pytest

from torchoptics_tpu_torch import imaging, simulator
from torchoptics_tpu_torch.models import zoo

CSRC = Path(__file__).resolve().parents[1] / "torchoptics_tpu_torch" / "csrc"

# (source, the routed list, the launcher's case pattern: label, instantiation)
ROUTES = {
    "p2": ("svola_conv.cu", "SPECIALIZED_KW",
           r"case (\d+):\s*return \(int\)launch<(\d+)>\("),
    "k2b": ("fused_batch_bwd.cu", "SHORT_SURF",
            r"case (\d+):\s*return launch<MODE, ALLOW_BACKWARD, MASKED, (\d+)>\("),
}


def _routes(kernel):
    source, name, case = ROUTES[kernel]
    text = (CSRC / source).read_text()
    listed = re.search(rf"constexpr int {name}\[\] = \{{([^}}]*)\}};", text)
    assert listed, f"{source} has no {name}"
    routed = [int(v) for v in listed.group(1).split(",")]
    cases = [(int(a), int(b)) for a, b in re.findall(case, text)]
    return text, routed, cases


@pytest.mark.parametrize("kernel", sorted(ROUTES))
def test_every_routed_size_has_its_instantiation(kernel):
    text, routed, cases = _routes(kernel)
    assert routed and len(set(routed)) == len(routed)
    assert all(label == inst for label, inst in cases), cases
    assert sorted(label for label, _ in cases) == sorted(routed), (routed, cases)
    # The C query the tests and chip_smoke.py ask reads the same list, and
    # every other size falls to the runtime-size instantiation (0).
    assert re.search(rf"for \(int k : {ROUTES[kernel][1]}\)", text)
    assert re.search(r"default:\s*return (\(int\))?launch<(MODE, ALLOW_BACKWARD, MASKED, )?0>\(",
                     text)


def test_main_paths_reach_the_specialised_kernels():
    """The renders' PSF widths and the populations' surface counts of the
    port's main paths (the generator's Cooke triplets, the mixed and
    double-Gauss populations) are routed to specialised kernels."""
    cfg = simulator.SimulatorConfig(psf_shape=(33, 33), psf_abs_pixel_size=4e-3,
                                    psf_grid_shape=(5, 5))
    kws = {imaging.psf_kernel_shape((px, px), cfg)[1] for px in (256, 512, 1024, 2048)}
    assert kws == {3, 5, 11, 23}
    assert kws <= set(_routes("p2")[1])
    surfaces = {len(zoo.get_prescription(name)["c"]) for name in ("cooke", "double_gauss")}
    assert surfaces == {7, 11}
    assert surfaces <= set(_routes("k2b")[1])
