"""The specialised CUDA kernels that the launchers route to exist in the
sources.

No CPU can build the kernels, so these tests read the ``.cu`` text: each
launcher's list of routed sizes (P2's and its d/dpsf's ``SPECIALIZED_KW``,
K1 forward's and K2 forward's and backward's ``SHORT_SURF``), the
``switch`` that dispatches on the size, and the instantiation each
``case`` launches. A size in the list without a ``case`` that launches its
own instantiation, or a ``case`` outside the list, fails. The imaging
renders' PSF sizes (256^2 to 2048^2 at BASELINE config 5; those on
d/dpsf's direct route too) and the zoo systems' surface counts that the
port's main paths run (the populations, K1 forward's double-Gauss and
Cooke) must each be routed to a specialised kernel, and every render from 256^2 to 4096^2, at config 5 and
at the default configuration (PSFs up to 95 taps), must pass P2's and its
d/dpsf's argument checks and take the intended route: the direct kernels
below the FFT route's thresholds (``image.P2_FFT_MIN_KW``,
``P2_DPSF_FFT_MIN_KW``), within the widths that the direct kernels'
sources fix as ``MAX_K``, and the FFT route (``csrc/svola_fft.cu``) from
there.
"""

import re
from pathlib import Path

import pytest

from torchoptics_tpu_torch import imaging, simulator
from torchoptics_tpu_torch.models import zoo
from torchoptics_tpu_torch.ops import image

CSRC = Path(__file__).resolve().parents[1] / "torchoptics_tpu_torch" / "csrc"

# (source, the routed list, the launcher's case pattern: label, instantiation;
# the launch of the runtime-size instantiation, 0, that every other size
# falls to)
ROUTES = {
    "p2": ("svola_conv.cu", "SPECIALIZED_KW",
           r"case (\d+):\s*return \(int\)launch<(\d+)>\(",
           r"default:\s*return \(int\)launch<0>\("),
    "p2_dpsf": ("svola_conv_bwd.cu", "SPECIALIZED_KW",
                r"case (\d+):\s*return \(int\)launch<(\d+)>\(",
                r"default:\s*return \(int\)launch<0>\("),
    "k1f": ("fused_trace_fwd.cu", "SHORT_SURF",
            r"case (\d+):\s*return launch<MODE, ALLOW_BACKWARD, (\d+)>\(",
            r"default:\s*return launch<MODE, ALLOW_BACKWARD, 0>\("),
    "k2b": ("fused_batch_bwd.cu", "SHORT_SURF",
            r"case (\d+):\s*return launch<MODE, ALLOW_BACKWARD, MASKED, (\d+)>\(",
            r"default:\s*return launch<MODE, ALLOW_BACKWARD, MASKED, 0>\("),
    "k2f": ("fused_batch_fwd.cu", "SHORT_SURF",
            r"case (\d+):\s*return launch<MODE, ALLOW_BACKWARD, MASKED, (\d+)>\(",
            r"default:\s*return launch<MODE, ALLOW_BACKWARD, MASKED, 0>\("),
}


def _routes(kernel):
    source, name, case, _ = ROUTES[kernel]
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
    assert re.search(ROUTES[kernel][3], text)


def test_main_paths_reach_the_specialised_kernels():
    """The renders' PSF widths and the populations' surface counts of the
    port's main paths (the generator's Cooke triplets, the mixed and
    double-Gauss populations) are routed to specialised kernels."""
    cfg = simulator.SimulatorConfig(psf_shape=(33, 33), psf_abs_pixel_size=4e-3,
                                    psf_grid_shape=(5, 5))
    kws = {imaging.psf_kernel_shape((px, px), cfg)[1] for px in (256, 512, 1024, 2048)}
    assert kws == {3, 5, 11, 23}
    direct = {kw for kw in kws if not image.p2_takes_fft((kw, kw))}
    assert direct and direct <= set(_routes("p2")[1])
    surfaces = {len(zoo.get_prescription(name)["c"]) for name in ("cooke", "double_gauss")}
    assert surfaces == {7, 11}
    assert surfaces <= set(_routes("k2b")[1])
    # K1 forward: the double-Gauss of the flagship paths and the Cooke of
    # RaytracedOptics; d/dpsf: the image-loss renders' PSF widths that take
    # the direct kernel.
    assert surfaces <= set(_routes("k1f")[1])
    # K2 forward: the generator's Cooke populations and the padded mixed
    # ones.
    assert surfaces <= set(_routes("k2f")[1])
    direct = {kw for kw in kws if not image.p2_takes_fft((kw, kw), adjoint=True)}
    assert direct and direct <= set(_routes("p2_dpsf")[1])


RENDER_CONFIGS = {
    "default": simulator.SimulatorConfig(),
    "config 5": simulator.SimulatorConfig(psf_shape=(33, 33), psf_abs_pixel_size=4e-3,
                                          psf_grid_shape=(5, 5)),
}
# (config, render side) -> the PSF width psf_kernel_shape gives.
RENDER_K = {("default", 1024): 23, ("default", 1448): 33, ("default", 2048): 47,
            ("default", 4096): 95, ("config 5", 1024): 11, ("config 5", 2048): 23,
            ("config 5", 4096): 47}
# (config, render side) -> the routes of P2 (forward and d/dpatch) and of
# d/dpsf; the other renders take the direct kernels both ways.
RENDER_ROUTES = {("default", 1024): ("fft", "fft"), ("default", 1448): ("fft", "fft"),
                 ("default", 2048): ("fft", "fft"), ("default", 4096): ("fft", "fft"),
                 ("config 5", 2048): ("fft", "fft"), ("config 5", 4096): ("fft", "fft")}


@pytest.mark.parametrize("name", sorted(RENDER_CONFIGS))
@pytest.mark.parametrize("px", [256, 512, 1024, 1448, 2048, 4096])
def test_every_render_passes_the_p2_checks(name, px):
    """The patches and PSFs of a px^2 render (their shapes as
    ``svola_convolution`` cuts them) pass the launchers' checks, forward and
    d/dpsf, and d/dpatch's padded cotangent passes P2's; each takes its
    intended route."""
    cfg = RENDER_CONFIGS[name]
    kh, kw = imaging.psf_kernel_shape((px, px), cfg)
    assert RENDER_K.get((name, px), kw) == kw and kh == kw and kw % 2 == 1
    gh, gw = cfg.psf_grid_shape
    overlap = int(0.25 * px / gh)
    ph = px // gh + 2 * overlap + kh - 1
    pw = px // gw + 2 * overlap + kw - 1
    patches, psfs = (gh * gw, ph, pw, 3), (gh * gw, kh, kw, 3)
    assert image.p2_argument_error(patches, psfs) is None
    assert image.p2_argument_error(patches, psfs, adjoint=True) is None
    padded = (gh * gw, ph + kh - 1, pw + kw - 1, 3)
    assert image.p2_argument_error(padded, psfs) is None
    routes = tuple("fft" if image.p2_takes_fft((kh, kw), adjoint) else "direct"
                   for adjoint in (False, True))
    assert routes == RENDER_ROUTES.get((name, px), ("direct", "direct"))


def test_p2_checks_refuse_what_the_kernels_cannot_take():
    """Both routes refuse too many patch-channels, a PSF larger than its
    patch and a channel mismatch; the FFT route patches longer than its
    longest transform. The direct kernels' widths (``MAX_K`` in their
    sources) reach at least one tap below the FFT route's thresholds, so
    every PSF has a route."""
    assert "65535" in image.p2_argument_error((30000, 40, 40, 3), (30000, 5, 5, 3))
    assert "65535" in image.p2_argument_error((30000, 60, 60, 3), (30000, 41, 5, 3))
    assert image.p2_argument_error((1, 40, 40, 3), (1, 41, 5, 3))
    assert image.p2_argument_error((1, 40, 40, 3), (1, 5, 5, 2))
    longest = image.P2_FFT_MAX_LEN
    for adjoint in (False, True):
        wide = image.P2_DPSF_FFT_MIN_KW if adjoint else image.P2_FFT_MIN_KW
        assert image.p2_max_kw(adjoint) >= wide - 1
        assert image.p2_takes_fft((3, wide), adjoint) and not image.p2_takes_fft(
            (wide - 1, wide - 1), adjoint)
        assert image.p2_argument_error((1, 40, longest, 1), (1, 3, wide, 1), adjoint) is None
        assert "pixels a side" in image.p2_argument_error((1, 40, longest + 1, 1),
                                                          (1, 3, wide, 1), adjoint)
        assert image.p2_argument_error((1, 40, longest + 1, 1), (1, 3, wide - 1, 1),
                                       adjoint) is None
    for source, adjoint in (("svola_conv.cu", False), ("svola_conv_bwd.cu", True)):
        text = (CSRC / source).read_text()
        assert int(re.search(r"constexpr int MAX_K = (\d+);", text).group(1)) == \
            image.p2_max_kw(adjoint)
    fft = (CSRC / "svola_fft.cu").read_text()
    assert int(re.search(r"constexpr int LMAX = (\d+);", fft).group(1)) == longest
    assert int(re.search(r"constexpr int LMIN = (\d+);", fft).group(1)) == image.P2_FFT_MIN_LEN
