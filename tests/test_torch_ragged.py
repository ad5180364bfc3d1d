"""The plain backward versions of kernels K1 and K4 against JAX at a ragged
shape: 5 fields x 13² circular pupil rays, 845 rays a wavelength, so that no
warp (32) or block (256) boundary falls on a wavelength's and the last block
of each system is partly inactive.

On the card, ``test_torch_kernels_cuda.py`` holds the backward kernels K1b
to K4b against these plain versions at the same shape, bit for bit on the
per-ray cotangents. Here the plain versions themselves are held to
``jax.vjp`` of JAX's jnp engine (the K1 and K4 parity files' ``_jnp_outputs``,
evaluated once per module for each backward-ray policy):

* K1 on the double-Gauss (11 surfaces, 3 wavelengths: 2,535 rays), the
  tight path and angle bounds of ``test_torch_fused_backward`` so that both
  hinges fire;
* K4 on the padded mixed conic/asphere population of
  ``test_torch_fused_asphere_batch`` (3 systems, GAGA, GAGAAGA and GA, 2
  wavelengths: 1,690 rays a system).

Plain, Lu and full modes, both policies. Bar: the parity files' own, each
cotangent within 1e-4 of its largest magnitude; against JAX, no theta_norm
cotangent on rays at the clip edge (and for K4 within ~1e-4 of normal
incidence), as those files do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fused_asphere_batch as k4_parity
import test_torch_fused_backward as k1_parity
from test_torch_asphere import port
from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace

RAGGED = dict(n_sampled_fields=5, n_pupil_rings=13)
MODES = [False, True, "full"]
N_COT = {False: 4, True: 7, "full": 9}


def _k1_side():
    cfg = simulator.SimulatorConfig(**dict(k1_parity.CONFIG, **RAGGED)).trace_config()
    specs, lens = zoo.build("double_gauss", device="cpu")
    xp, yp, cyb, z0, mu, shape = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    n_per_w = shape[1] * shape[2]
    arrays = [a.detach().numpy() for a in (xp, yp, cyb, z0, lens.c[0], lens.t[0], mu)]
    vertex_z = np.cumsum(arrays[5], dtype=np.float32)
    ref_z = np.concatenate((vertex_z, vertex_z[-1:]))
    bounds = fused_trace._path_bounds(lens.structure, k1_parity.LOWER, k1_parity.UPPER)
    n = arrays[0].shape[0]
    rng = np.random.default_rng(5)
    cot = [rng.standard_normal(n).astype(np.float32) for _ in range(9)]
    edge = k1_parity._at_clip_edge([torch.tensor(a) for a in arrays], n_per_w)
    cot = [np.where(edge, 0.0, a).astype(np.float32) if i in (4, 5) else a
           for i, a in enumerate(cot)]
    grads = {}
    for ab in (True, False):
        _, vjp = jax.vjp(functools.partial(k1_parity._jnp_outputs, bounds, ab, n_per_w=n_per_w),
                         *map(jnp.asarray, arrays + [ref_z]))
        for p in MODES:
            kept = cot[:N_COT[p]] + [np.zeros(n, np.float32)] * (9 - N_COT[p])
            grads[ab, p] = [np.asarray(a) for a in vjp(tuple(map(jnp.asarray, kept)))]
    return dict(inputs=arrays, ref_z=ref_z, bounds=bounds, cot=cot, n_per_w=n_per_w,
                grads=grads)


def _k4_side():
    jspecs, jlens = k4_parity._kernel_population()
    specs, lens = port(jspecs, jlens)
    cfg = simulator.SimulatorConfig(**dict(k4_parity.CONFIG, **RAGGED)).trace_config()
    xp, yp, cyb, z0, mu, shape = fused_batch.prepare_fused_inputs_batch(specs, lens, cfg)
    n_per_w = shape[1] * shape[2]
    arrays = [a.detach().numpy() for a in (xp, yp, cyb, z0, lens.c, lens.kappa, lens.t, mu,
                                           lens.asph)]
    vertex_z = np.cumsum(arrays[6], axis=1, dtype=np.float32)
    arrays.append(np.concatenate((vertex_z, vertex_z[:, -1:]), axis=1))
    mask = lens.structure.mask
    widest = np.array([int(np.argmax(lens.structure.n_surfaces))])
    bounds = fused_trace._path_bounds(lens[widest].structure, k4_parity.LOWER, k4_parity.UPPER)
    n_sys, n = arrays[0].shape
    rng = np.random.default_rng(6)
    cot = [rng.standard_normal((n_sys, n)).astype(np.float32) for _ in range(9)]
    _, sens_max, edge = k4_parity._theta_sensitivity([torch.tensor(a) for a in arrays],
                                                     torch.tensor(mask), n_per_w)
    cut = (sens_max > 20.0) | edge
    cot = [np.where(cut, 0.0, a).astype(np.float32) if i in (4, 5) else a
           for i, a in enumerate(cot)]
    grads = {}
    for ab in (True, False):
        _, vjp, _ = jax.vjp(functools.partial(k4_parity._jnp_outputs, mask, bounds, ab,
                                              n_per_w=n_per_w),
                            *map(jnp.asarray, arrays), has_aux=True)
        for p in MODES:
            kept = cot[:N_COT[p]] + [np.zeros((n_sys, n), np.float32)] * (9 - N_COT[p])
            grads[ab, p] = [np.asarray(a) for a in vjp(list(map(jnp.asarray, kept)))]
    return dict(inputs=arrays, mask=mask, bounds=bounds, cot=cot, n_per_w=n_per_w, grads=grads)


@pytest.fixture(scope="module")
def jax_side():
    return {"k1": _k1_side(), "k4": _k4_side()}


def _assert_ragged(n_per_w, n):
    assert n_per_w % 32 != 0 and n % 256 != 0, (n_per_w, n)


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_k1_backward_reference_matches_jax_at_a_ragged_shape(allow_backward, penalties,
                                                             jax_side):
    ref = jax_side["k1"]
    _assert_ragged(ref["n_per_w"], ref["inputs"][0].shape[0])
    ins = [torch.tensor(a) for a in ref["inputs"]]
    if penalties == "full":
        ins.append(torch.tensor(ref["ref_z"]))
    cot = [torch.tensor(a) for a in ref["cot"][:N_COT[penalties]]]
    got = fused_trace.trace_fused_backward_reference(
        ins, cot, penalties, allow_backward, ref["n_per_w"], ref["bounds"], k1_parity.THR)
    want = ref["grads"][allow_backward, penalties]
    assert len(got) == (8 if penalties == "full" else 7)
    for g, w, label in zip(got, want, k1_parity.LABELS):
        k1_parity._assert_rel_close(g.numpy(), w, label)


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_k4_backward_reference_matches_jax_at_a_ragged_shape(allow_backward, penalties,
                                                             jax_side):
    ref = jax_side["k4"]
    _assert_ragged(ref["n_per_w"], ref["inputs"][0].shape[1])
    ins = [torch.tensor(a) for a in ref["inputs"][:10 if penalties == "full" else 9]]
    cot = [torch.tensor(a) for a in ref["cot"][:N_COT[penalties]]]
    got = fused_asphere.trace_fused_asphere_batch_backward_reference(
        ins, cot, penalties, allow_backward, ref["n_per_w"], 10, torch.tensor(ref["mask"]),
        ref["bounds"], k4_parity.THR)
    want = ref["grads"][allow_backward, penalties]
    assert len(got) == (10 if penalties == "full" else 9)
    for g, w, label in zip(got, want, k4_parity.LABELS):
        k4_parity._assert_rel_close(g.numpy(), w, label)
