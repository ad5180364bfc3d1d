"""Port parity for ``ops.vignetting``: the solver, its first-blocked-crossing
edge search, and the ``vig_fn`` factories.

The same lenses go through the JAX package and the port (on the CPU): a
padded population of the Cooke triplet and the Tessar, solved against the
apertures of its axial beam with one ray-aiming iteration, and the Tessar
against tightened apertures without aiming, both at n_scan = 65. On the
JAX side each solve runs once for the module, jitted with a fast compile on
threads, with its fans' aperture margins (the JAX solver's own closure,
written out below on the JAX trace).

Bars: the blocked masks (margin > 1) identical, and the test asserts so;
the tables within 1e-4 where they agree; margins and the interpolation
helpers within 5e-6; the edge search on hand-made margins exact.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import trace as jtrace
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import vignetting as jvig
from torchoptics_tpu_torch import trace, zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import vignetting as vig

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
REL_FIELDS = (0.0, 0.5, 1.0)
N_SCAN = 65
TABLES = ("vig_up", "vig_down", "vig_x", "q_up", "q_down", "q_x", "semi_apertures")


def _port(jspecs, jlens):
    st = jlens.structure
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    lens = convert.lens_from_numpy(st.stop_idx, st.sequence,
                                   *(np.asarray(a) for a in (jlens.c, jlens.t, jlens.nd,
                                                             jlens.v)), device="cpu")
    return specs, lens


def _jax_of(specs, lens):
    st = lens.structure
    jst = JStructure(st.stop_idx, st.sequence)
    arr = lambda a: jnp.asarray(a.detach().numpy())
    return (JSpecs(jst, arr(specs.epd), arr(specs.hfov)),
            JLens(jst, arr(lens.c), arr(lens.t), arr(lens.nd), arr(lens.v)))


def _jax_margins(specs, lens, cfg, xp, yp, sa):
    """The JAX solver's ``fan_margins`` closure (ops/vignetting.py:186-200)."""
    res = jtrace.trace_rays(specs, lens, cfg, xy=(xp, yp), aggregate=("x", "y"))
    r = jtrace._safe_sqrt(res.stacks["x"] ** 2 + res.stacks["y"] ** 2)
    r = jnp.moveaxis(r, 0, 1)[..., 0]
    m = r / jnp.maximum(sa[:, :, None, None], 1e-12)
    m = jnp.where(jnp.asarray(lens.structure.mask)[:, :, None, None], m, 0.0)
    m = jnp.max(m, axis=1)
    return jnp.where(res.ray_ok[..., 0], m, jnp.inf)


def _cases():
    """name -> (JAX specs, lens, semi-aperture scale or None, aiming iterations)."""
    mixed = _jax_of(*zoo.mixed_population(2, names=("cooke", "tessar"), device="cpu"))
    return {"mixed": mixed + (None, 1), "tessar_tight": jzoo.build("tessar") + (0.9, 0)}


def _solve_jax(case):
    jspecs, jlens, scale, aim = case

    def run(c):
        lens = jlens.replace(c=c)
        sa = None
        if scale is not None:
            sa = jvig.solve_vignetting(jspecs, lens, REL_FIELDS, n_scan=N_SCAN,
                                       n_ray_aiming_iter=aim)["semi_apertures"] * scale
        out = jvig.solve_vignetting(jspecs, lens, REL_FIELDS, semi_apertures=sa,
                                    n_scan=N_SCAN, n_ray_aiming_iter=aim)
        cfg = jtrace.TraceConfig(mode="tee", rel_fields=REL_FIELDS, wavelengths=("d",),
                                 n_ray_aiming_iter=aim)
        p = jnp.linspace(-1.0, 1.0, N_SCAN).reshape(1, 1, -1, 1)
        sa_t = out["semi_apertures"] * (1.0 + 1e-6)
        out["m_y"] = _jax_margins(jspecs, lens, cfg, jnp.zeros_like(p), p, sa_t)
        out["m_x"] = _jax_margins(jspecs, lens, cfg, p, jnp.zeros_like(p), sa_t)
        return out

    compiled = jax.jit(run).lower(jlens.c).compile(FAST_COMPILE)
    return {k: np.asarray(v) for k, v in compiled(jlens.c).items()}


@pytest.fixture(scope="module")
def sides():
    cases = _cases()
    with ThreadPoolExecutor(len(cases)) as pool:
        jax_out = dict(zip(cases, pool.map(_solve_jax, cases.values())))
    port_out = {}
    for name, (jspecs, jlens, scale, aim) in cases.items():
        specs, lens = _port(jspecs, jlens)
        sa = None
        if scale is not None:
            sa = vig.solve_vignetting(specs, lens, REL_FIELDS, n_scan=N_SCAN,
                                      n_ray_aiming_iter=aim)["semi_apertures"] * scale
        out = vig.solve_vignetting(specs, lens, REL_FIELDS, semi_apertures=sa, n_scan=N_SCAN,
                                   n_ray_aiming_iter=aim)
        cfg = trace.TraceConfig(mode="tee", rel_fields=REL_FIELDS, wavelengths=("d",),
                                n_ray_aiming_iter=aim)
        p = torch.linspace(-1.0, 1.0, N_SCAN).reshape(1, 1, -1, 1)
        sa_t = out["semi_apertures"] * (1.0 + 1e-6)
        out["m_y"] = vig._fan_margins(specs, lens, cfg, torch.zeros_like(p), p, sa_t)
        out["m_x"] = vig._fan_margins(specs, lens, cfg, p, torch.zeros_like(p), sa_t)
        port_out[name] = {k: v.numpy() for k, v in out.items()}
    return jax_out, port_out


@pytest.mark.parametrize("name", ["mixed", "tessar_tight"])
def test_solver_matches_jax(sides, name):
    jax_out, port_out = sides
    got, want = port_out[name], jax_out[name]
    for fan in ("m_y", "m_x"):
        # The blocked masks agree, then the margins of the passing rays.
        np.testing.assert_array_equal(got[fan] > 1.0, want[fan] > 1.0, err_msg=fan)
        np.testing.assert_array_equal(np.isinf(got[fan]), np.isinf(want[fan]), err_msg=fan)
        fin = np.isfinite(want[fan])
        np.testing.assert_allclose(got[fan][fin], want[fan][fin], rtol=5e-6, atol=5e-6)
    for k in TABLES:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    # The tight apertures do vignette: the solver's edge search took its
    # interpolating branch somewhere.
    if name == "tessar_tight":
        assert np.any(got["vig_up"][:, 1:] > 0.05)


def test_edge_search_matches_jax():
    """``_edge`` on hand-made margins: blocked samples on both sides, a
    killed (inf) first-blocked sample (t = 0), a blocked chief ray (edge 0),
    a row with nothing blocked (the grid's end), and ties, where the first
    blocked sample outward must win."""
    pupil_np = np.linspace(-1.0, 1.0, 9)
    m = np.full((5, 9), 0.5, np.float32)
    m[0, 6:] = [1.4, 0.3, 2.0]          # up: first blocked at 6 (not 8)
    m[0, :2] = [3.0, 1.2]               # down: the last blocked below the chief is 1
    m[1, 7] = np.inf                    # killed ray: crossing at the last passing one
    m[1, 2] = np.inf
    m[2, 4] = 1.5                       # the chief ray itself blocked
    m[4, [5, 6, 7]] = 1.5               # a run of equal blocked margins
    m[4, [0, 1, 3]] = 1.5
    for upper in (True, False):
        got = vig._edge(torch.tensor(m), pupil_np, upper).numpy()
        want = np.asarray(jvig._edge(jnp.asarray(m), pupil_np, upper))
        np.testing.assert_array_equal(got, want)
    up = vig._edge(torch.tensor(m), pupil_np, True).numpy()
    assert up[2] == 0.0 and up[3] == 1.0
    np.testing.assert_allclose(up[1], pupil_np[6])


def test_interp_and_table_vig_fns_match_jax():
    """The ``jnp.interp`` counterpart: unsorted solved fields, queries inside,
    on the nodes and outside the table (clamped to its end values), and a
    zero-width interval; ``solved_tables_vig_fn`` with distinct tables;
    ``fit_quadratic_vig`` and ``quadratic_vig_fn``."""
    rng = np.random.default_rng(7)
    fields = (1.0, 0.0, 0.5, 0.5, 0.8)
    table = rng.uniform(0.0, 0.6, (3, len(fields))).astype(np.float32)
    query = np.asarray([[-0.2, 0.0, 0.3, 0.5, 0.65, 0.8, 0.95, 1.0, 1.3]], np.float32)
    got = vig.table_vig_fn(fields, torch.tensor(table))(torch.tensor(query), None).numpy()
    want = np.asarray(jvig.table_vig_fn(fields, jnp.asarray(table))(jnp.asarray(query), None))
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=5e-6)
    got = vig.solved_tables_vig_fn(fields)(torch.tensor(query), torch.tensor(table)).numpy()
    want = np.asarray(jvig.solved_tables_vig_fn(fields)(jnp.asarray(query), jnp.asarray(table)))
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(got[:, 0], table[:, 1])        # clamped below the table
    np.testing.assert_allclose(got[:, -1], table[:, 0])       # and above it
    q = vig.fit_quadratic_vig(fields, torch.tensor(table)).numpy()
    np.testing.assert_allclose(q, np.asarray(jvig.fit_quadratic_vig(fields, jnp.asarray(table))),
                               rtol=5e-6)
    np.testing.assert_array_equal(vig.fit_quadratic_vig((0.0, 0.0), torch.ones(2, 2)).numpy(),
                                  np.zeros(2, np.float32))
    np.testing.assert_allclose(
        vig.quadratic_vig_fn(torch.tensor(query), torch.tensor(q)).numpy(),
        np.asarray(jvig.quadratic_vig_fn(jnp.asarray(query), jnp.asarray(q))), rtol=1e-6)


def test_solved_tables_drive_the_trace_inside_the_apertures():
    """The solved tables, put into the specs and read back by
    ``solved_tables_vig_fn``, vignette the port's own trace so that every
    meridional and sagittal edge ray stays inside the solved apertures."""
    specs, lens = zoo.build("tessar", device="cpu")
    out = vig.solve_vignetting(specs, lens, REL_FIELDS, n_scan=N_SCAN, n_ray_aiming_iter=0)
    specs_v = specs.replace(vig_up=out["vig_up"], vig_down=out["vig_down"], vig_x=out["vig_x"])
    cfg = trace.TraceConfig(mode="tee", rel_fields=REL_FIELDS, wavelengths=("d",),
                            vig_fn=vig.solved_tables_vig_fn(REL_FIELDS))
    p = torch.linspace(-1.0, 1.0, N_SCAN).reshape(1, 1, -1, 1)
    xy = (torch.cat((torch.zeros_like(p), p), dim=2), torch.cat((p, torch.zeros_like(p)), dim=2))
    fields = torch.tensor(REL_FIELDS)[None, :]
    torch.testing.assert_close(cfg.vig_fn(fields, specs_v.vig_up), out["vig_up"])
    res = trace.trace_rays(specs_v, lens, cfg, xy=xy, aggregate=("x", "y"))
    r = torch.sqrt(res.stacks["x"] ** 2 + res.stacks["y"] ** 2).movedim(0, 1)[..., 0]
    assert bool(torch.all(r <= out["semi_apertures"][:, :, None, None] * 1.005))


def test_solver_gradient_is_nan_free():
    """d/dc through the solver is finite and nonzero: the chief ray's hit
    radius is 0 at field 0, where ``_safe_sqrt`` keeps the gradient."""
    specs, lens = zoo.build("tessar", device="cpu")
    c = lens.c.clone().requires_grad_(True)
    out = vig.solve_vignetting(specs, lens.replace(c=c), REL_FIELDS, n_scan=25,
                               n_ray_aiming_iter=0)
    (g,) = torch.autograd.grad(torch.sum(out["vig_up"]) + torch.sum(out["vig_x"]), c)
    assert bool(torch.all(torch.isfinite(g))) and float(torch.linalg.norm(g)) > 0.0
