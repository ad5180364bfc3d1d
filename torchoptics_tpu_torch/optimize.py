"""Gradient-based lens optimization with ``torch.optim.Adam``.

PyTorch counterpart of ``torchoptics_tpu.optimize``:

* :func:`get_normalized_lens_variables`: lens -> trainable parameters
  ``{'c', 't', 'g'}`` (curvatures minus the solved and air-air slots,
  thicknesses, whitened glass), scaled to EFL == 1.
* :func:`lens_from_normalized`: parameters -> Lens, with quantized-continuous
  glass (straight-through), the analytic last-curvature solve and the
  optional BFL re-addition.
* :class:`LensOptimizer`: Adam steps on those parameters against the
  unsupervised loss Lu or the full weighted loss. PyTorch runs eagerly, so
  there is no ``jit``; on the fused engine a step launches K1 forward and
  K1 backward once each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch import simulator as sim_mod
from torchoptics_tpu_torch.models import glass as glass_mod
from torchoptics_tpu_torch.models.structure import (
    Lens, Specs, Structure, find_valid_curvatures, mask_gather, mask_scatter)
from torchoptics_tpu_torch.ops import abcd as abcd_mod


def _add_at_last_surface(structure: Structure, t2d: torch.Tensor,
                         value: torch.Tensor) -> torch.Tensor:
    """``t2d`` with ``value`` (B,) added at each system's last surface."""
    rows = torch.as_tensor(np.arange(len(structure)), device=t2d.device)
    last = torch.as_tensor(structure.n_surfaces - 1, device=t2d.device)
    return t2d.index_put((rows, last), value, accumulate=True)


def get_normalized_lens_variables(lens: Lens, add_bfl: bool = False,
                                  scale_factor: float = 1.0) -> Dict[str, torch.Tensor]:
    """Trainable variables of a lens. The lens is first scaled so EFL == 1
    (the working scale of the last-curvature solve); glass goes to whitened
    ``g`` space; with ``add_bfl`` the BFL is subtracted from the last
    thickness, so the trainable value is the defocus. Conic and asphere
    coefficients are included when the lens carries them."""
    lens = lens.scale(1.0 / lens.efl)
    g = glass_mod.g_from_n_v(lens.flat_nd, lens.flat_v) * scale_factor
    t2d = lens.t
    if add_bfl:
        t2d = _add_at_last_surface(lens.structure, t2d, -lens.bfl)
    t = mask_gather(lens.structure.mask, t2d) * scale_factor
    c = mask_gather(find_valid_curvatures(lens.structure), lens.c) * scale_factor
    params = {"c": c, "t": t, "g": g}
    if lens.kappa is not None:
        params["kappa"] = lens.kappa * scale_factor
    if lens.asph is not None:
        params["asph"] = lens.asph * scale_factor
    return params


def lens_from_normalized(structure: Structure, params: Dict[str, torch.Tensor],
                         catalog_g: Optional[torch.Tensor] = None,
                         add_bfl: bool = False, scale_factor: float = 1.0,
                         qc_variables: bool = True) -> Lens:
    """Rebuild a Lens from normalized variables. The last curvature is solved
    analytically so EFL == 1; with ``qc_variables`` the glass variables snap
    to the nearest catalog glass with a straight-through gradient."""
    c = params["c"] / scale_factor
    t = params["t"] / scale_factor
    g = params["g"] / scale_factor
    if qc_variables and catalog_g is not None:
        g = glass_mod.quantize_glass_st(g, catalog_g)
    nd, v = glass_mod.n_v_from_g(g)

    # The optimized curvatures go into their slots; the air-air and last
    # slots stay 0 and the last is solved.
    c2d = mask_scatter(find_valid_curvatures(structure), c, 0.0)
    c_mask = structure.mask.copy()
    c_mask[np.arange(len(structure)), structure.n_surfaces - 1] = False
    flat_c = abcd_mod.compute_last_curvature(structure, mask_gather(c_mask, c2d), t, nd)
    kappa, asph = params.get("kappa"), params.get("asph")
    lens = Lens(structure, flat_c, t, nd, v,
                kappa=None if kappa is None else kappa / scale_factor,
                asph=None if asph is None else asph / scale_factor)
    if add_bfl:
        lens = lens.replace(t=_add_at_last_surface(structure, lens.t, lens.bfl))
    return lens


def set_adam_moments(adam: torch.optim.Adam, params: Dict[str, torch.Tensor],
                     exp_avg: Dict[str, torch.Tensor], exp_avg_sq: Dict[str, torch.Tensor],
                     count: int) -> None:
    """Give ``adam`` the moments (optax's ``mu`` and ``nu``) and step count
    of each of ``params``, as if it had taken ``count`` steps."""
    for k, p in params.items():
        adam.state[p] = {"step": torch.tensor(float(count)),
                         "exp_avg": exp_avg[k].detach().clone().to(p),
                         "exp_avg_sq": exp_avg_sq[k].detach().clone().to(p)}


class OptState(NamedTuple):
    """``params``: the leaf tensors Adam updates in place; ``opt_state``: the
    ``torch.optim.Adam`` over them (moments and its own step count);
    ``step``: the number of steps taken, rejected ones included."""
    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Adam
    step: int


@dataclass
class LensOptimizer:
    """Adam-based lens designer: optimizes (c, t, g) against the
    unsupervised loss Lu (``use_full_loss=False``) or the full weighted loss.

    The optimizer is ``torch.optim.Adam(lr=learning_rate)`` with optax's
    ``adam`` defaults: betas 0.9 and 0.999, eps = 1e-8 added outside the
    square root. The two round float32 differently (optax divides the bias
    corrections into the moments, torch into the step size and the root).
    ``step`` updates the parameters of the state in place and returns the
    state with its step count advanced.
    """

    specs: Specs
    config: sim_mod.SimulatorConfig
    learning_rate: float = 1e-3
    add_bfl: bool = True
    scale_factor: float = 1.0
    qc_variables: bool = True
    use_full_loss: bool = False  # include the ray-path, ray-angle and glass penalties
    trainable: Tuple[str, ...] = ("c", "t", "g")
    catalog_g: Optional[torch.Tensor] = None
    efl_target: Optional[float] = None
    # Optional objective override with the compute_losses signature
    # (specs, lens, config, g, catalog_g, generator) -> (total, loss_dict).
    loss_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.catalog_g is None and self.qc_variables:
            self.catalog_g = glass_mod.default_catalog_g(device=self.specs.device)

    def _adam(self, params: Dict[str, torch.Tensor]) -> torch.optim.Adam:
        return torch.optim.Adam(list(params.values()), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    def init(self, lens: Lens) -> OptState:
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in get_normalized_lens_variables(
                      lens, self.add_bfl, self.scale_factor).items()}
        return OptState(params, self._adam(params), 0)

    def init_from(self, params: Dict[str, torch.Tensor],
                  exp_avg: Optional[Dict[str, torch.Tensor]] = None,
                  exp_avg_sq: Optional[Dict[str, torch.Tensor]] = None,
                  count: int = 0, step: int = 0) -> OptState:
        """A state from given parameters and, optionally, Adam moments and
        their step count (optax's ``mu``, ``nu`` and ``count``)."""
        params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        adam = self._adam(params)
        if exp_avg is not None:
            set_adam_moments(adam, params, exp_avg, exp_avg_sq, count)
        return OptState(params, adam, step)

    def build_lens(self, params: Dict[str, torch.Tensor]) -> Lens:
        lens = lens_from_normalized(self.specs.structure, params, self.catalog_g,
                                    self.add_bfl, self.scale_factor, self.qc_variables)
        if self.efl_target is not None:
            lens = lens.scale(self.efl_target / lens.efl)
        return lens

    def loss(self, params: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        lens = self.build_lens(params)
        g = params["g"] / self.scale_factor
        if self.loss_fn is not None:
            return self.loss_fn(self.specs, lens, self.config, g, self.catalog_g, generator)
        if self.use_full_loss:
            return sim_mod.compute_losses(self.specs, lens, self.config, g=g,
                                          catalog_g=self.catalog_g, generator=generator)
        _, loss_dict = sim_mod.do_ray_tracing(self.specs, lens, self.config,
                                              generator=generator)
        return loss_dict["loss_unsup"], loss_dict

    def _gradients(self, total: torch.Tensor, params: Dict[str, torch.Tensor]):
        """d total / d params, in the order of ``params`` (None where unused)."""
        return torch.autograd.grad(total, list(params.values()), allow_unused=True)

    def step(self, state: OptState, generator: Optional[torch.Generator] = None):
        """One Adam step. The gradients of groups not in ``trainable`` are
        zeroed (not dropped, so Adam's moments decay as in the JAX package).
        A step whose loss or gradients are not finite is rejected: parameters,
        moments and Adam's step count stay as they were; ``state.step`` still
        advances. Returns (state, total, loss_dict)."""
        params = state.params
        total, loss_dict = self.loss(params, generator)
        grads = self._gradients(total, params)
        finite = torch.isfinite(total)
        for k, p, g in zip(params, params.values(), grads):
            g = torch.zeros_like(p) if g is None or k not in self.trainable else g
            p.grad = g
            finite = finite & torch.all(torch.isfinite(g))
        if bool(finite):
            state.opt_state.step()
        for p in params.values():
            p.grad = None
        detached = {k: v.detach() for k, v in loss_dict.items()}
        return OptState(params, state.opt_state, state.step + 1), total.detach(), detached

    def run(self, lens: Lens, n_steps: int, generator: Optional[torch.Generator] = None,
            log_every: int = 0):
        """Optimize for ``n_steps``; returns (final lens, final state, loss
        history)."""
        state = self.init(lens)
        history = []
        for i in range(n_steps):
            state, _, loss_dict = self.step(state, generator)
            if log_every and i % log_every == 0:
                history.append({k: float(v) for k, v in loss_dict.items()})
        with torch.no_grad():
            final = self.build_lens(state.params).detach()
        return final, state, history
