"""Port parity for kernel K1 forward's module, ``ops.fused_trace``.

``trace_fused_reference`` (the plain PyTorch version of the CUDA kernel) is
held against the JAX package on the same wavelength-outer inputs, taken from
JAX's ``prepare_fused_inputs``: against JAX's jnp engine, and against the
Pallas kernel ``pallas_trace.trace_fused`` run in interpret mode on the CPU.
Tolerances: coordinates on rays that are ok in both within 5e-6 + 1e-6
relative (float32 rounding at ~7 mm image heights); ``ray_ok`` and
``ray_backward`` identical; the per-ray penalty sums within 1e-5 (11 terms).
The CUDA kernel itself is checked against the plain version on a GPU by
``test_torch_kernels_cuda.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.ops import pallas_trace as jpt
from torchoptics_tpu.ops import trace as jtrace_mod
from torchoptics_tpu_torch import simulator, trace, zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import fused_trace

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=8, pupil_sampling="circular",
              n_ray_aiming_iter=1)
LENSES = {"double_gauss": 1.0, "double_gauss_c3": 3.0}
MODES = [(True, True), (True, False), (False, True), (False, False)]
N_PER_W = 3 * 8 * 8  # fields x pupil rays of CONFIG


def _inputs_np(jspecs, jlens, cfg):
    xp, yp, cyb, z0, mu, shape = jpt.prepare_fused_inputs(jspecs, jlens, cfg,
                                                          w_order="outer")
    arrays = [np.asarray(a) for a in (xp, yp, cyb, z0, jlens.c[0], jlens.t[0], mu)]
    return arrays, shape


def _jax_unroll(arrays, n_per_w, allow_backward):
    """JAX's jnp engine (``trace.trace_skew``) on the kernel's flat inputs:
    ray i gets its wavelength's index ratios, the Lu penalties come from the
    per-surface stacks."""
    xp, yp, cyb, z0, c, t, mu = (jnp.asarray(a) for a in arrays)
    n, n_surf = xp.shape[0], c.shape[0]
    widx = np.minimum(np.arange(n) // n_per_w, mu.shape[1] - 1)
    col = lambda a: a.reshape(1, 1, -1, 1)
    surf = lambda a: a.reshape(1, 1, 1, 1, n_surf)
    res = jtrace_mod.trace_skew(
        col(xp), col(yp), z0.reshape(1, 1, 1, 1), jnp.zeros((1, 1, 1, 1)), col(cyb),
        surf(c), surf(t), mu[:, widx].T.reshape(1, 1, n, 1, n_surf),
        jnp.ones((1, 1, 1, 1, n_surf), bool), aggregate=jtrace_mod.AGG_TORCH,
        allow_backward_rays=allow_backward)
    pens = [res.stacks[k].sum(0) for k in ("theta_norm", "theta_prime_norm", "z_RELU")]
    return [np.asarray(a).reshape(-1) for a in list(res[:6]) + pens]


@pytest.fixture(scope="module")
def jax_side():
    """Per lens: JAX's front-end outputs, the Pallas kernel's outputs in Lu
    mode with both backward-ray policies, and JAX's jnp engine on the same
    flat inputs. (Each Pallas mode costs an interpret-mode compile of several
    seconds; plain mode's outputs are the first six of Lu mode's.)"""
    cfg = jsim.SimulatorConfig(**CONFIG).trace_config()
    pallas = {(pen, ab): jax.jit(functools.partial(
                  jpt.trace_fused, penalties=pen, allow_backward=ab,
                  n_per_w=N_PER_W))
              for pen, ab in ((True, True), (True, False))}
    out = {}
    for name, c_scale in LENSES.items():
        jspecs, jlens = jzoo.build("double_gauss")
        jlens = jlens.replace(c=jlens.c * c_scale)
        arrays, shape = _inputs_np(jspecs, jlens, cfg)
        assert shape[1] * shape[2] == N_PER_W
        with pltpu.force_tpu_interpret_mode():
            outs = {mode: [np.asarray(o) for o in fn(*arrays)]
                    for mode, fn in pallas.items()}
        unroll = {ab: _jax_unroll(arrays, N_PER_W, ab) for ab in (True, False)}
        out[name] = dict(specs=jspecs, lens=jlens, inputs=arrays, shape=shape,
                         pallas=outs, unroll=unroll)
    return out


def _pallas_reference(outs, penalties, allow_backward):
    # Plain mode computes the first six outputs of Lu mode unchanged.
    lu = outs[(True, allow_backward)]
    return lu if penalties else lu[:6]


def _np(outs):
    return [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in outs]


def assert_k1_close(got, want, penalties, slack=None):
    """The kernel-module tolerances (module docstring); ``slack`` widens each
    float comparison by a per-element distance measured elsewhere."""
    got, want = _np(got), _np(want)
    assert len(got) == len(want) == (9 if penalties else 6)
    ok, jok = got[4], want[4]
    np.testing.assert_array_equal(ok, jok, err_msg="ray_ok")
    np.testing.assert_array_equal(got[5], want[5], err_msg="ray_backward")
    both = ok & jok
    labels = ("x", "y", "cx", "cy", None, None, "pen_theta", "pen_theta_p", "pen_zrelu")
    for i, label in enumerate(labels[:len(got)]):
        if label is None:
            continue
        sel = both if i < 4 else np.ones_like(both)
        tol = (5e-6 + 1e-6 * np.abs(want[i])) if i < 4 else np.full(want[i].shape, 1e-5)
        if slack is not None:
            tol = tol + slack[i]
        err = np.abs(got[i] - want[i])
        bad = sel & ~(err <= tol)
        assert not bad.any(), (f"{label}: {int(bad.sum())} of {int(sel.sum())} rays out "
                               f"of tolerance, max excess {np.max((err - tol)[sel])}")


@pytest.mark.parametrize("name", list(LENSES))
@pytest.mark.parametrize("penalties,allow_backward", MODES)
def test_reference_matches_jax_engine(name, penalties, allow_backward, jax_side):
    """The plain version against JAX's jnp engine on the same flat inputs, at
    the full tolerances."""
    ref = jax_side[name]
    args = [torch.tensor(a) for a in ref["inputs"]]
    got = fused_trace.trace_fused_reference(*args, penalties, allow_backward, N_PER_W)
    want = ref["unroll"][allow_backward]
    assert_k1_close(got, want if penalties else want[:6], penalties)
    if name == "double_gauss_c3":
        assert 0 < got[4].float().mean() < 1, "the c x 3 lens must fail some rays"


@pytest.mark.parametrize("name", list(LENSES))
@pytest.mark.parametrize("penalties,allow_backward", MODES)
def test_reference_matches_pallas_kernel(name, penalties, allow_backward, jax_side):
    """The plain version against the Pallas kernel in interpret mode: masks
    identical, and every value no further from the Pallas kernel than JAX's
    own jnp engine is, plus the full tolerances. (Interpret mode rounds
    differently from the jnp engine; near normal incidence theta_norm
    amplifies one ulp of cos² up to ~4e-5, and on the c x 3 lens a few
    grazing rays amplify one ulp to ~2e-4 mm.)"""
    ref = jax_side[name]
    args = [torch.tensor(a) for a in ref["inputs"]]
    got = fused_trace.trace_fused_reference(*args, penalties, allow_backward, N_PER_W)
    want = _pallas_reference(ref["pallas"], penalties, allow_backward)
    unroll = ref["unroll"][allow_backward][:len(want)]
    slack = [np.abs(u.astype(np.float64) - w) if u.dtype != bool else None
             for u, w in zip(unroll, _np(want))]
    assert_k1_close(got, want, penalties, slack=slack)


def _port(jspecs, jlens):
    st = jlens.structure
    lens = convert.lens_from_numpy(st.stop_idx, st.sequence, np.asarray(jlens.c),
                                   np.asarray(jlens.t), np.asarray(jlens.nd),
                                   np.asarray(jlens.v), device="cpu")
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    return specs, lens


@pytest.mark.parametrize("name", list(LENSES))
def test_front_end_matches_jax(name, jax_side):
    """Flat ray block, pupil position and index ratios. The aimed pupil
    coordinates agree within 1e-5 of their scale (see test_torch_trace's
    ray-aiming test for why)."""
    ref = jax_side[name]
    specs, lens = _port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    xp, yp, cyb, z0, mu, shape = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    assert shape == ref["shape"]
    jxp, jyp, jcy, jz0, _, _, jmu = ref["inputs"]
    for a, b in ((xp, jxp), (yp, jyp)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(cyb.numpy(), jcy, rtol=1e-6)
    np.testing.assert_allclose(z0.numpy(), jz0, rtol=1e-6)
    np.testing.assert_allclose(mu.numpy(), jmu, rtol=1e-6)
    assert all(a.is_contiguous() for a in (xp, yp, cyb, mu))


def test_trace_fused_runs_the_plain_version_on_cpu(jax_side):
    ref = jax_side["double_gauss"]
    _, F, P, _ = ref["shape"]
    args = [torch.tensor(a) for a in ref["inputs"]]
    before = fused_trace.K1_FWD_LAUNCHES
    got = fused_trace.trace_fused(*args, True, True, F * P)
    want = fused_trace.trace_fused_reference(*args, True, True, F * P)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_trace.K1_FWD_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_trace.trace_fused(*[a.to("meta") for a in args], True, True, F * P)


def test_trace_rays_fused_matches_unroll_engine():
    """The packaged (1, F, P, W) result of the fused path equals the
    pure-torch engine's on the same lens."""
    specs, lens = zoo.build("double_gauss", device="cpu")
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    res_u = trace.trace_rays(specs, lens, cfg)
    res_f = trace.trace_rays(specs, lens, simulator.SimulatorConfig(
        **CONFIG, trace_engine="fused").trace_config())
    assert res_f.x.shape == res_u.x.shape == (1, 3, 64, 3) and res_f.stacks is None
    assert torch.equal(res_f.ray_ok, res_u.ray_ok)
    assert torch.equal(res_f.ray_backward, res_u.ray_backward)
    for a, b in zip(res_f[:4], res_u[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=5e-6)


def test_fused_engine_refuses_what_it_cannot_trace():
    """The fused engine traces the aspherized double-Gauss (kernel K3, its
    plain version here), and still refuses aggregate stacks and double
    precision."""
    specs, lens = zoo.build("double_gauss", device="cpu")
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused").trace_config()
    with pytest.raises(NotImplementedError, match="aggregate"):
        trace.trace_rays(specs, lens, cfg, aggregate=("z",))
    with pytest.raises(NotImplementedError, match="float32"):
        trace.trace_rays(specs, lens, dataclasses.replace(cfg, double_precision=True))
    asph_specs, asph_lens = zoo.build("double_gauss_asph", device="cpu")
    res = trace.trace_rays(asph_specs, asph_lens, cfg)
    assert res.x.shape == (1, 3, 64, 3) and res.stacks is None
    assert bool(res.ray_ok.all()) and bool(torch.isfinite(res.y).all())
    with pytest.raises(NotImplementedError, match="aggregate"):
        trace.trace_rays(asph_specs, asph_lens, cfg, aggregate=("z",))
    with pytest.raises(NotImplementedError, match="float32"):
        trace.trace_rays(asph_specs, asph_lens, dataclasses.replace(cfg, double_precision=True))
    with pytest.raises(ValueError, match="plain"):
        fused_trace.prepare_fused_inputs(specs, lens, cfg,
                                         xy=(torch.zeros(1, 3, 4, 1), torch.zeros(1, 3, 4, 1)))
