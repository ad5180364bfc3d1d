"""Built-in lens prescriptions.

The same prescriptions as ``torchoptics_tpu.models.zoo``, as plain data:
singlet, doublet, Cooke triplet and Tessar (all hfov 25 deg, f/2), the
6-element double-Gauss flagship and its radial-metric and aspherized
siblings. Each prescription is a dict:

    stop_idx: [int]      index of the aperture-stop surface
    sequence: [str]      G/A gap string, one char per surface
    hfov:     [deg]      half field of view
    f_number: [float]
    c, t:     per-surface curvature / thickness
    nd, v:    per-glass d-line index / Abbe number
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure

# fmt: off
SINGLET = {
    "stop_idx": [0], "sequence": ["AGA"], "hfov": [25.0], "f_number": [2.0],
    "c": [0.0, 0.01867167465388775, -0.04616425931453705],
    "t": [6.715000152587891, 3.0007503032684326, 15.0230131149292],
    "nd": [1.916499376296997],
    "v": [31.60358428955078],
}

DOUBLET = {
    "stop_idx": [2], "sequence": ["GAAGA"], "hfov": [25.0], "f_number": [2.0],
    "c": [0.059835370630025864, 0.04363778978586197, 0.0,
          0.022557824850082397, -0.0437268428504467],
    "t": [1.6105520725250244, 5.601459980010986, 6.902040481567383,
          2.890363931655884, 12.037284851074219],
    "nd": [1.6778998374938965, 1.8918993473052979],
    "v": [55.3400764465332, 37.133338928222656],
}

COOKE = {
    "stop_idx": [4], "sequence": ["GAGAAGA"], "hfov": [25.0], "f_number": [2.0],
    "c": [0.10994608700275421, 0.014736141078174114, -0.03834565356373787,
          0.11981328576803207, 0.0, 0.03997667506337166, -0.0657755583524704],
    "t": [2.4371840953826904, 0.5665456652641296, 1.0000001192092896,
          0.844669759273529, 1.6025489568710327, 3.0, 13.061942100524902],
    "nd": [1.7638500928878784, 1.6258817911148071, 1.7638500928878784],
    "v": [48.48774719238281, 35.69896697998047, 48.48774719238281],
}

TESSAR = {
    "stop_idx": [4], "sequence": ["GAGAAGGA"], "hfov": [25.0], "f_number": [2.0],
    "c": [0.11917586624622345, 0.03537517040967941, -0.032270871102809906,
          0.13348394632339478, 0.0, 0.057362884283065796,
          -0.14504458010196686, -0.07696522772312164],
    "t": [2.6051883697509766, 0.8061898946762085, 1.000000238418579,
          1.5986409187316895, 0.14155136048793793, 2.999530076980591,
          1.1733624935150146, 12.837242126464844],
    "nd": [1.7638611793518066, 1.6259105205535889, 1.7638611793518066,
           1.9166003465652466],
    "v": [48.4895133972168, 35.70527267456055, 48.4895133972168,
          31.602611541748047],
}

# 6-element double Gauss, EFL 50 mm, f/2, hfov 19 deg, GAGGAAGGAGA with
# two cemented doublets around the stop. Prescription designed with this
# framework's own optimizer (torchoptics_tpu.optimize; staged start, then
# a 24-start perturbation population refined jointly on one chip against
# mean spot RMS with min-thickness 0.8 mm, image clearance >= 12 mm and
# track <= 110 mm hinges, catalog glass frozen). 100% ray transmission at
# f/2 over the full field; polychromatic RMS spot 0.0034 mm (11 fields x
# 24^2 rays x 3 wavelengths). Flagship benchmark scene for BASELINE.json
# config 3 ("Double-Gauss 6-element: dense pupil-grid trace").
DOUBLE_GAUSS = {
    "stop_idx": [5], "sequence": ["GAGGAAGGAGA"], "hfov": [19.0],
    "f_number": [2.0],
    "c": [0.012928937561810017, 0.010133822448551655, 0.018386458978056908, 0.02228051796555519, 0.008862107992172241, 0.0, -0.014622754417359829, 0.045521512627601624, -0.019115237519145012, 0.020866703242063522, -0.0097695617005229],
    "t": [3.1662492752075195, 2.5869171619415283, 3.7229623794555664, 3.963953971862793, 18.828838348388672, 0.7999454140663147, 0.7999827861785889, 18.961557388305664, 0.7999398708343506, 44.375885009765625, 11.998907089233398],
    "nd": [1.6778998374938965, 1.6515969038009644, 1.737999439239502, 1.737999439239502, 1.6515969038009644, 1.6778998374938965],
    "v": [55.3400764465332, 58.5494499206543, 32.2607307434082, 32.2607307434082, 58.5494499206543, 55.3400764465332],
}
# Radial-metric sibling of the double Gauss: same topology/glass, refined
# against the 2-D (xy) spot RMS (`metrics.compute_spot_rms_xy`) instead of
# the reference-parity Y-deviation metric, which is blind to sagittal blur
# (`ray_tracing_lite.py:678-702` measures y only). The y-refined flagship
# reads rms_y 0.0038 but its radial truth is rms_xy 0.078 (0.154 at the
# field edge); this design trades to rms_y 0.016 / rms_xy 0.021 (0.032 at
# the edge) at 100% transmission — ~4x tighter off-axis where it counts.
# Recipe: examples/refine_flagship.py --metric xy (keep-best snapshots).
DOUBLE_GAUSS_XY = {
    "stop_idx": [5], "sequence": ["GAGGAAGGAGA"], "hfov": [19.0],
    "f_number": [2.0],
    "c": [0.014554506167769432, 0.006289103999733925, 0.022626444697380066, 0.03690723329782486, 0.024477176368236542, 0.0, -0.026548957452178, 0.05122699961066246, -0.03053668513894081, 0.02640804648399353, 0.01444872748106718],
    "t": [2.8194401264190674, 1.1764885187149048, 3.7081003189086914, 10.759910583496094, 9.233357429504395, 0.7993483543395996, 0.7997804880142212, 21.603954315185547, 0.7997656464576721, 41.803611755371094, 11.998438835144043],
    "nd": [1.6778998374938965, 1.6515969038009644, 1.737999439239502, 1.737999439239502, 1.6515969038009644, 1.6778998374938965],
    "v": [55.3400764465332, 58.5494499206543, 32.2607307434082, 32.2607307434082, 58.5494499206543, 55.3400764465332],
}
# fmt: on


# Aspherized variant of the double Gauss: conic constants + two even-asphere
# coefficients (r^4, r^6) on every surface, jointly re-optimized with c/t
# from the refined spherical parent (same thickness/clearance/track
# hinges). Polychromatic RMS spot 0.0011 mm at f/2 (geometrically below
# the ~1.3 um Airy radius) over the full 19 deg half field with 100% ray
# transmission — ~3x tighter than the (already refined) spherical parent.
# Flagship scene for the conic/asphere superset (BASELINE north star; see
# ops/pallas_asphere).
DOUBLE_GAUSS_ASPH = {
    "stop_idx": [5], "sequence": ["GAGGAAGGAGA"], "hfov": [19.0],
    "f_number": [2.0],
    "c": [0.011578227393329144, 0.013699766248464584, 0.015704303979873657, 0.014053762890398502, 0.010045737028121948, 0.0, -0.012353694066405296, 0.028375018388032913, -0.017914462834596634, 0.021928099915385246, -0.010894794948399067],
    "t": [3.207486629486084, 3.7748920917510986, 3.73964524269104, 3.9978654384613037, 32.31959533691406, 0.800284743309021, 0.8001888394355774, 1.5128982067108154, 0.8000879883766174, 31.047771453857422, 28.008983612060547],
    "nd": DOUBLE_GAUSS["nd"],
    "v": DOUBLE_GAUSS["v"],
    "kappa": [-0.05220562964677811, 0.030199339613318443, -0.08236600458621979, 0.31483978033065796, 0.015358314849436283, 0.0, 0.11754149198532104, -0.5059533715248108, 0.05366222560405731, -0.024514369666576385, -0.20395579934120178],
    "asph": [[-3.2555360007791023e-07, -2.6781102335782236e-10], [1.4868712128190964e-07, -9.131102818304981e-11], [-5.338698656487395e-07, -5.1910236525953835e-11], [2.410550450804294e-06, 2.122549247474126e-09], [5.074907960533892e-08, 5.381894929712416e-10], [9.656168913352303e-06, 2.6058927238281626e-10], [-1.0646998589436407e-06, 7.328275208884349e-10], [-4.1074199543800205e-06, -2.3845652119547367e-09], [-4.225510963351553e-07, 1.0861155030905678e-10], [-2.3477605282096192e-07, -6.589367940179613e-10], [1.6099927506729728e-06, 9.635343634073479e-10]],
}

# Radial-metric aspherized flagship: conic + r^4/r^6 terms jointly
# re-optimized from the DOUBLE_GAUSS_XY parent against the radial 2-D spot
# RMS (examples/refine_flagship.py --lens double_gauss_xy --aspherize
# --metric xy). Where DOUBLE_GAUSS_ASPH's radial truth is 0.065 mm mean /
# 0.129 mm at the field edge (its y-only objective never saw the sagittal
# blur), this design measures rms_xy 0.0044 mm mean / 0.0069 mm edge AND
# rms_y 0.0028 mm — radially ~15x tighter off-axis while beating the
# *spherical* y-flagship on the reference's own metric, at 100%
# transmission. The best photographic design in the zoo.
# fmt: off
DOUBLE_GAUSS_ASPH_XY = {
    "stop_idx": [5], "sequence": ["GAGGAAGGAGA"], "hfov": [19.0],
    "f_number": [2.0],
    "c": [0.006173975300043821, 0.011108829639852047, 0.022080160677433014, 0.018033716827630997, 0.013675778172910213, 0.0, -0.02215453051030636, 0.021737800911068916, -0.0332721471786499, 0.03160027042031288, 0.03482900187373161],
    "t": [1.158659815788269, 2.248185396194458, 3.657710313796997, 3.1868600845336914, 22.511306762695312, 0.7998887896537781, 18.577590942382812, 3.4666595458984375, 0.7998051047325134, 29.972673416137695, 23.632997512817383],
    "nd": DOUBLE_GAUSS["nd"],
    "v": DOUBLE_GAUSS["v"],
    "kappa": [0.007160924840718508, 0.03104523941874504, -0.13356231153011322, 0.454739511013031, 0.09641707688570023, 0.0, 0.688910186290741, -0.8041915893554688, 0.017625585198402405, -0.1573670208454132, 0.4081938862800598],
    "asph": [[2.4000198095563974e-07, -4.875347903166016e-10], [2.9792678901685576e-07, 1.1868035443285407e-09], [-1.2696110616161604e-06, 1.1783480857729955e-09], [1.8313395457880688e-06, 3.6227214561534993e-09], [4.007555389762274e-07, 9.62406931925841e-10], [7.82309416536009e-06, -2.133839771545354e-09], [-1.4915842712071026e-06, -1.0179949327948634e-08], [-9.109940037888009e-06, 3.1042286519067375e-09], [1.1090209000030882e-06, -7.01060154373323e-10], [-8.47623368827044e-07, -9.225069597107449e-10], [-1.090266891878855e-06, 9.367889575173649e-09]],
}
# fmt: on

ZOO: Dict[str, dict] = {
    "singlet": SINGLET,
    "doublet": DOUBLET,
    "cooke": COOKE,
    "tessar": TESSAR,
    "double_gauss": DOUBLE_GAUSS,
    "double_gauss_xy": DOUBLE_GAUSS_XY,
    "double_gauss_asph": DOUBLE_GAUSS_ASPH,
    "double_gauss_asph_xy": DOUBLE_GAUSS_ASPH_XY,
}


def get_prescription(name: str) -> dict:
    return copy.deepcopy(ZOO[name])


def build(prescription, device="cuda", dtype=torch.float32) -> Tuple[Specs, Lens]:
    """Construct (Specs, Lens) on ``device`` (the GPU unless the caller asks
    for another) from a prescription dict or a ``ZOO`` name. EPD is derived
    as EFL / f_number unless given."""
    if isinstance(prescription, str):
        prescription = get_prescription(prescription)
    p = prescription
    tensor = lambda v: torch.tensor(v, dtype=dtype, device=device)
    structure = Structure(tuple(int(i) for i in p["stop_idx"]), tuple(p["sequence"]))
    asph = None
    if "asph" in p:
        asph = tensor(p["asph"])
        if asph.ndim == 2:  # (S, K) prescription -> single-system batch
            asph = asph[None]
    lens = Lens(structure, tensor(p["c"]), tensor(p["t"]), tensor(p["nd"]),
                tensor(p["v"]),
                kappa=tensor(p["kappa"]) if "kappa" in p else None, asph=asph)
    hfov = torch.deg2rad(tensor(p["hfov"]))
    if "epd" in p:
        epd = tensor(p["epd"])
    else:
        epd = lens.efl / tensor(p["f_number"])
    return Specs(structure, epd, hfov), lens


def population(name: str, n: int, seed: int = 0, device="cuda") -> Tuple[Specs, Lens]:
    """``n`` copies of a zoo prescription with every curvature perturbed by
    2 % (seeded numpy normal draws): the homogeneous population of the
    generator-loss benchmark (``benchmarks/bench_generator_loss.py``
    ``make_population``), with the same draws for the same seed. A
    prescription's conic constants and asphere coefficients are carried,
    unperturbed, to every copy."""
    p = get_prescription(name)
    rng = np.random.default_rng(seed)
    c = np.tile(np.asarray(p["c"], np.float32), (n, 1))
    c *= 1.0 + 0.02 * rng.standard_normal(c.shape).astype(np.float32)
    base_specs, base = build(name, device=device)
    structure = Structure(tuple(p["stop_idx"]) * n, tuple(p["sequence"]) * n)
    tile = lambda a: None if a is None else a.repeat(n, *([1] * (a.ndim - 1)))
    lens = Lens(structure, torch.tensor(c, device=device), tile(base.t), tile(base.nd),
                tile(base.v), kappa=tile(base.kappa), asph=tile(base.asph))
    return Specs(structure, base_specs.epd.repeat(n), base_specs.hfov.repeat(n)), lens


def aspheric_population(n: int, name="cooke", seed: int = 0, asph_seed: int = 1,
                        device="cuda", mask_pad: bool = False) -> Tuple[Specs, Lens]:
    """A population of conic/asphere designs: ``population(name, n, seed)``
    (the 2 % curvature draw), then a conic constant kappa ~ U(-0.3, 0.1) on
    every surface, (B, S), and two even-asphere terms (r⁴, r⁶) drawn as
    U(-1, 1) x [1e-5, 1e-8], (B, S, 2), both from
    ``np.random.default_rng(asph_seed)`` in that order: the aspherized
    population of the generator-loss benchmark's "pallas-asphere" row
    (``benchmarks/bench_generator_loss.py``), the same numbers for the same
    seeds.

    With ``mask_pad`` the base is the padded mixed population
    ``mixed_population(n, name, seed)`` (``name`` a tuple of zoo names) and
    the draws are multiplied by its surface mask, as the JAX package's
    batched-asphere parity test draws them: padded slots carry zero conics
    and coefficients."""
    if mask_pad:
        specs, lens = mixed_population(n, name, seed=seed, device=device)
    else:
        specs, lens = population(name, n, seed=seed, device=device)
    rng = np.random.default_rng(asph_seed)
    mask = lens.structure.mask
    kappa = rng.uniform(-0.3, 0.1, mask.shape) * mask
    asph = rng.uniform(-1, 1, mask.shape + (2,)) * np.asarray([1e-5, 1e-8]) * mask[..., None]
    as_tensor = lambda a: torch.tensor(a.astype(np.float32), device=device)
    return specs, lens.replace(kappa=as_tensor(kappa), asph=as_tensor(asph))


def mixed_population(n: int, names=("cooke", "double_gauss"), seed: int = 0,
                     device="cuda") -> Tuple[Specs, Lens]:
    """A population mixing lens types, padded to the widest sequence:
    n / len(names) copies of each prescription, curvatures perturbed by 2 %
    (``bench_generator_loss.make_mixed_population``, the same draws for the
    same seed)."""
    rng = np.random.default_rng(seed)
    per = n // len(names)
    stops, seqs, rows, specs_rows = [], [], [], []
    for name in names:
        p = get_prescription(name)
        base_specs, base = build(name, device=device)
        c0 = np.asarray(p["c"], np.float32)
        for _ in range(per):
            stops.append(p["stop_idx"][0])
            seqs.append(p["sequence"][0])
            c = c0 * (1 + 0.02 * rng.standard_normal(c0.shape)).astype(np.float32)
            rows.append((torch.tensor(c, device=device), base.flat_t, base.flat_nd,
                         base.flat_v))
            specs_rows.append((base_specs.epd, base_specs.hfov))
    structure = Structure(tuple(stops), tuple(seqs))
    flat = [torch.cat(parts) for parts in zip(*rows)]
    epd, hfov = (torch.cat(parts) for parts in zip(*specs_rows))
    return Specs(structure, epd, hfov), Lens(structure, *flat)
