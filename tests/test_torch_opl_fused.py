"""Port parity for the opl (optical path length) mode of kernels K1-K4 and
``wavefront.optical_path_lengths`` on both engines.

The JAX side, evaluated once for the module, is JAX's jnp engine, the plain
reference of its Pallas opl kernels (``tests/test_opl_fused.py`` holds the
kernels to it), in its scan form, each case jitted with a fast compile on
its own thread (eagerly, the backward pass through the Newton steps takes
~30 s a lens). Cases, as ``tests/test_opl_fused.py`` builds them: the Cooke triplet
and the aspherized double-Gauss, 3 fields x 4² circular pupil x 3
wavelengths with one ray-aiming iteration, and two-system populations of
each (the second system's curvatures x 1.01) at 2 wavelengths.

The port runs ``engine="unroll"`` (the pure-torch engine's ``"dist"``
aggregate) and ``engine="fused"`` (on CPU tensors the opl mode's plain
versions and hand adjoints: K1, K3, K2 and K4). Bars, JAX's own between its
kernels and its jnp engine: masks identical; OPL within rtol 1e-6 and atol
1e-5 mm (spherical) or 5e-5 mm (asphere); d/d(c, t, nd[, asph]) of the
masked OPL sum within rtol 2e-5 and atol 2e-6 x the largest magnitude.

The plain versions' hand adjoints are also held against
``torch.autograd.grad`` through their forwards, d/d n_legs included (1e-4
of each cotangent's largest magnitude, as ``test_torch_fused_backward.py``).
The CUDA kernels are held against the plain versions on a GPU by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import trace as jtrace
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import wavefront as jwf
from torchoptics_tpu_torch import trace, zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace
from torchoptics_tpu_torch.ops import wavefront as wf

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BAR = 1e-4
# (lens, population of two, wavelengths)
CASES = {
    "cooke": ("cooke", False, ("C", "d", "F")),
    "double_gauss_asph": ("double_gauss_asph", False, ("C", "d", "F")),
    "cooke_pop2": ("cooke", True, ("C", "d")),
    "double_gauss_asph_pop2": ("double_gauss_asph", True, ("C", "d")),
}


def _config(wavelengths, **kw):
    return dict(mode="circular", n_rays=(4, 4), rel_fields=(0.0, 0.7, 1.0),
                wavelengths=wavelengths, n_ray_aiming_iter=1, **kw)


def _population2(jspecs, jlens):
    """Two same-structure systems, the second with curvatures x 1.01
    (``tests/test_opl_fused.py``)."""
    struct2 = JStructure(tuple(jlens.structure.stop_idx) * 2, tuple(jlens.structure.sequence) * 2)
    twice = lambda a: None if a is None else jnp.concatenate([a, a], axis=0)
    lens2 = jlens.replace(structure=struct2, c=jnp.concatenate([jlens.c, jlens.c * 1.01], axis=0),
                          t=twice(jlens.t), nd=twice(jlens.nd), v=twice(jlens.v),
                          kappa=twice(jlens.kappa), asph=twice(jlens.asph))
    return JSpecs(struct2, twice(jspecs.epd), twice(jspecs.hfov)), lens2


def _jax_lens(name):
    jspecs, jlens = jzoo.build(CASES[name][0])
    return _population2(jspecs, jlens) if CASES[name][1] else (jspecs, jlens)


def _params(jlens):
    return ("c", "t", "nd") + (("asph",) if jlens.asph is not None else ())


def _port(jspecs, jlens):
    st = jlens.structure
    opt = lambda a: None if a is None else np.asarray(a)
    lens = convert.lens_from_numpy(
        st.stop_idx, st.sequence, *(np.asarray(a) for a in (jlens.c, jlens.t, jlens.nd, jlens.v)),
        device="cpu", kappa=opt(jlens.kappa), asph=opt(jlens.asph))
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    return specs, lens


@pytest.fixture(scope="module")
def jax_side():
    """Per case: ray_ok, OPL and the gradient of the masked OPL sum."""
    def program(name):
        jspecs, jlens = _jax_lens(name)
        params = _params(jlens)
        cfg = jtrace.TraceConfig(**_config(CASES[name][2], engine="scan"))

        def f(*vals):
            res, opl = jwf.optical_path_lengths(jspecs, jlens.replace(**dict(zip(params, vals))),
                                                cfg)
            return jnp.sum(jnp.where(res.ray_ok, opl, 0.0)), (res.ray_ok, opl)

        args = [getattr(jlens, k) for k in params]
        fn = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(params))), has_aux=True))
        (_, (ok, opl)), grads = fn.lower(*args).compile(FAST_COMPILE)(*args)
        return name, {"ok": np.asarray(ok), "opl": np.asarray(opl),
                      "grads": dict(zip(params, (np.asarray(g) for g in grads)))}

    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(pool.map(program, CASES))


@pytest.mark.parametrize("engine", ["unroll", "fused"])
@pytest.mark.parametrize("name", list(CASES))
def test_optical_path_lengths_match_jax(name, engine, jax_side):
    """OPL and d/d(c, t, nd[, asph]) of the masked OPL sum on either engine
    against JAX's jnp engine; ``engine="fused"`` goes through K1, K3, K2 or
    K4 by the lens (``tests/test_opl_fused.py``'s bars)."""
    want = jax_side[name]
    jspecs, jlens = _jax_lens(name)
    specs, lens = _port(jspecs, jlens)
    params = _params(jlens)
    cfg = trace.TraceConfig(**_config(CASES[name][2], engine=engine))
    leaves = [getattr(lens, k).clone().requires_grad_(True) for k in params]
    res, opl = wf.optical_path_lengths(specs, lens.replace(**dict(zip(params, leaves))), cfg)
    np.testing.assert_array_equal(res.ray_ok.numpy(), want["ok"])
    ok = want["ok"]
    atol = 5e-5 if "asph" in params else 1e-5
    np.testing.assert_allclose(opl.detach().numpy()[ok], want["opl"][ok], rtol=1e-6, atol=atol)
    grads = torch.autograd.grad(torch.sum(torch.where(res.ray_ok, opl, 0.0)), leaves)
    for k, g in zip(params, grads):
        w = want["grads"][k]
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-6 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def _assert_rel_close(got, want, label, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= bar * scale, (
        f"{label}: {np.abs(got - want).max() / scale:.3e} of the largest magnitude (bar {bar})")


def _kernel_inputs(name, c_scale, batch):
    """The flat wavelength-outer inputs of the opl kernels on the port's
    front-end (3 fields x 6² x 3 wavelengths), with n_legs; for a population
    the lens and a copy with curvatures x 1.02. Asphere inputs carry kappa
    and asph."""
    cfg = trace.TraceConfig(**dict(_config(("C", "d", "F")), n_rays=(6, 6)))
    specs, lens = zoo.build(name, device="cpu")
    lens = lens.replace(c=lens.c * c_scale)
    if batch:
        specs, lens = zoo.population(name, 2, device="cpu")
        lens = lens.replace(c=lens.c * torch.tensor([[c_scale], [1.02 * c_scale]]))
    lens = fused_asphere.with_asphere_terms(lens) if not lens.is_spherical else lens
    with torch.no_grad():
        xp, yp, cy, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(specs, lens, cfg)
    n_legs = fused_trace.leg_indices(lens, cfg.wavelengths)
    if lens.is_spherical:
        ins = [xp, yp, cy, z0, lens.c, lens.t, mu, n_legs]
    else:
        ins = [xp, yp, cy, z0, lens.c, lens.kappa, lens.t, mu, lens.asph, n_legs]
    if not batch:
        ins = [a.reshape(()) if i == 3 else a[0] for i, a in enumerate(ins)]
    return [a.detach().contiguous() for a in ins], F * P


KERNELS = {
    # name: (lens, population, plain forward, plain backward)
    "K1": ("double_gauss", False, fused_trace.trace_fused_reference,
           fused_trace.trace_fused_backward_reference),
    "K2": ("cooke", True, fused_batch.trace_fused_batch_reference,
           fused_batch.trace_fused_batch_backward_reference),
    "K3": ("double_gauss_asph", False, fused_asphere.trace_fused_asphere_reference,
           fused_asphere.trace_fused_asphere_backward_reference),
    "K4": ("double_gauss_asph", True, fused_asphere.trace_fused_asphere_batch_reference,
           fused_asphere.trace_fused_asphere_batch_backward_reference),
}


def _plain_forward(kernel, ins, allow_backward, n_per_w):
    forward = KERNELS[kernel][2]
    if kernel in ("K1", "K2"):
        return forward(*ins[:7], "opl", allow_backward, n_per_w, n_legs=ins[7])
    return forward(*ins[:9], "opl", allow_backward, n_per_w, n_legs=ins[9])


def _guarded_lanes(ins, batch, n_per_w):
    """The rays that meet the sag-domain guard (or a stationary F') at some
    surface of the asphere trace."""
    one = ins if batch else fused_asphere._one(ins)
    guard = torch.zeros(one[0].shape, dtype=torch.bool)

    def keep(k, pre, loc, kill, post):
        guard.logical_or_(loc["guard_pre"] | loc["guard2"] | loc["stationary"])
    fused_asphere._trace_batch(*one[:9], True, n_per_w, fused_asphere.NEWTON_ITERS, keep)
    return guard.reshape(ins[0].shape)


@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_hand_adjoint_matches_autograd(kernel, allow_backward):
    """Each opl plain backward against autograd through its plain forward
    on a lens where rays fail and (without backward rays) are removed, with
    seeded cotangents on x, y, cx, cy and opl: every input's cotangent,
    d/d n_legs included. A failed ray's legs still count in its OPL (the
    callers mask it); on the asphere rays that meet the sag-domain guard,
    the hand adjoint (JAX's Pallas kernel's) differentiates w = sqrt(1 - u)
    where the forward holds it at 1, and autograd does not, so those rays
    get no OPL cotangent here."""
    name, batch = KERNELS[kernel][:2]
    ins, n_per_w = _kernel_inputs(name, 1.5 if name == "cooke" else 3.0, batch)
    leaves = [a.clone().requires_grad_(True) for a in ins]
    outs = _plain_forward(kernel, leaves, allow_backward, n_per_w)
    assert len(outs) == 7
    ok = outs[4]
    assert 0 < float(ok.float().mean()) < 1, "some rays must fail"
    gen = torch.Generator().manual_seed(3)
    cot = [torch.randn(ins[0].shape, generator=gen) for _ in range(5)]
    if kernel in ("K3", "K4"):
        cot[4] = torch.where(_guarded_lanes(ins, batch, n_per_w), 0.0, cot[4])
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    want = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), leaves)
    got = KERNELS[kernel][3](ins, cot, "opl", allow_backward, n_per_w)
    assert len(got) == len(ins)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel_close(g.numpy(), w.numpy(), f"{kernel} input {i}")
    assert float(got[-1].abs().max()) > 0, "d/d n_legs must not vanish"


@pytest.mark.parametrize("asphere", [False, True])
def test_population_of_one_is_the_single_system_kernel(asphere):
    """K2's opl plain version at B = 1 equals K1's, and K4's equals K3's, bit
    for bit: the forward and the per-ray and parameter cotangents."""
    name = "double_gauss_asph" if asphere else "double_gauss"
    single, one = ("K3", "K4") if asphere else ("K1", "K2")
    ins, n_per_w = _kernel_inputs(name, 1.0, False)
    ins_b = [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(ins)]
    gen = torch.Generator().manual_seed(4)
    cot = [torch.randn(ins[0].shape, generator=gen) for _ in range(5)]
    got = _plain_forward(single, ins, True, n_per_w)
    want = _plain_forward(one, ins_b, True, n_per_w)
    for a, b in zip(got, want):
        assert torch.equal(a, b[0])
    got = KERNELS[single][3](ins, cot, "opl", True, n_per_w)
    want = KERNELS[one][3](ins_b, [c[None] for c in cot], "opl", True, n_per_w)
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(b.shape), b)


def test_function_runs_the_plain_versions_on_cpu():
    """``trace_fused_opl`` on CPU tensors: the plain forward, and on backward
    the plain hand adjoint, d/d n_legs included."""
    ins, n_per_w = _kernel_inputs("double_gauss", 3.0, False)
    leaves = [a.clone().requires_grad_(True) for a in ins]
    outs = fused_trace.trace_fused_opl(*leaves, True, n_per_w)
    want = fused_trace.trace_fused_reference(*ins[:7], "opl", True, n_per_w, n_legs=ins[7])
    for a, b in zip(outs, want):
        assert torch.equal(a.detach(), b)
    gen = torch.Generator().manual_seed(5)
    cot = [torch.randn(ins[0].shape, generator=gen) for _ in range(5)]
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    grads = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), leaves)
    ref = fused_trace.trace_fused_backward_reference(ins, cot, "opl", True, n_per_w)
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)


def test_opl_raises_where_it_cannot_run():
    """The fused OPL is float32 only; the plain-mode entry points name the
    opl ones."""
    specs, lens = zoo.build("cooke", device="cpu")
    cfg = trace.TraceConfig(**_config(("d",), engine="fused", double_precision=True))
    with pytest.raises(NotImplementedError, match="float32.*double"):
        wf.optical_path_lengths(specs, lens, cfg)
    ins, n_per_w = _kernel_inputs("cooke", 1.0, False)
    with pytest.raises(ValueError, match="trace_fused_opl"):
        fused_trace.trace_fused(*ins[:7], "opl", True, n_per_w)
    ins_b, _ = _kernel_inputs("cooke", 1.0, True)
    with pytest.raises(ValueError, match="trace_fused_batch_opl"):
        fused_batch.trace_fused_batch(*ins_b[:7], "opl", True, n_per_w)
    specs_p, lens_p = zoo.population("cooke", 2, device="cpu")
    bad_xy = (torch.zeros(1, 3, 16, 1), torch.zeros(1, 3, 16, 1))
    with pytest.raises(ValueError, match="pupil samples"):
        wf.optical_path_lengths(specs_p, lens_p, dataclasses.replace(cfg, double_precision=False),
                                xy=bad_xy)
