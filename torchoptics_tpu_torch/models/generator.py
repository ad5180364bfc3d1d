"""The lens-design generator of the ``train_generator`` example.

``GeneratorMLP`` maps lens specifications (EPD, HFOV) to design vectors
(glass g-pairs, curvatures, thicknesses) for an ``OpticalLoss``;
``generate`` scales its outputs about ``base_design``; ``sample_specs``
draws specs in the example's ranges; ``batch_loss`` scores a batch with
``OpticalLoss.unsupervised``. ``models.convert.mlp_params_from_numpy``
carries the JAX example's MLP parameters into a ``GeneratorMLP``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class GeneratorMLP(torch.nn.Module):
    """The JAX example's ``mlp``: layers ``x @ w + b`` with the tanh GELU
    (``jax.nn.gelu``'s default) between them. Weights start as its
    ``init_mlp`` draws them, N(0, 2 / fan_in), from ``generator`` (a CPU
    ``torch.Generator``), and biases at 0; ``models.convert.
    mlp_params_from_numpy`` carries JAX's parameters across instead."""

    def __init__(self, sizes, generator=None, device="cuda"):
        super().__init__()
        ws, bs = [], []
        for din, dout in zip(sizes[:-1], sizes[1:]):
            w = torch.randn(din, dout, generator=generator) * (2.0 / din) ** 0.5
            ws.append(torch.nn.Parameter(w.to(device)))
            bs.append(torch.nn.Parameter(torch.zeros(dout, device=device)))
        self.w = torch.nn.ParameterList(ws)
        self.b = torch.nn.ParameterList(bs)

    def forward(self, x):
        for w, b in zip(self.w[:-1], self.b[:-1]):
            x = F.gelu(x @ w + b, approximate="tanh")
        return x @ self.w[-1] + self.b[-1]


def base_design(ol, device="cuda") -> torch.Tensor:
    """The output heads' offsets: glass at the catalog centre, curvature 0.3
    (EFL-1 scale), thicknesses 0.2."""
    G, S = ol.numglass, ol.numsurf
    base = torch.zeros(ol.numout)
    base[2 * G: 2 * G + S - 1] = 0.3
    base[2 * G + S - 1:] = 0.2
    return base.to(device)


def sample_specs(generator, n, device="cuda") -> torch.Tensor:
    """(n, 2) specs in the example's ranges: EPD in [0.15, 0.35], HFOV in
    [0.2, 0.45] rad."""
    u = torch.rand(n, 2, generator=generator, device=device)
    return torch.stack((0.15 + 0.2 * u[:, 0], 0.2 + 0.25 * u[:, 1]), dim=1)


def snap_outputs_st(outputs, ol, catalog_g):
    """Glass heads quantized to the catalog with a straight-through
    gradient (``glass.quantize_glass_st``)."""
    from torchoptics_tpu_torch.models import glass as glass_mod
    G = ol.numglass
    g_q = glass_mod.quantize_glass_st(outputs[:, : 2 * G].reshape(-1, 2), catalog_g)
    return torch.cat((g_q.reshape(outputs.shape[0], 2 * G), outputs[:, 2 * G:]), dim=1)


def generate(net, inputs, base):
    """Design vectors of the specs ``inputs``: the network's outputs scaled
    by 0.1 about ``base``."""
    return net(inputs) * 0.1 + base


def batch_loss(ol, net, inputs, base, engine, catalog_g=None):
    """Mean Lu of the batch's designs (``OpticalLoss.unsupervised``);
    ``catalog_g`` snaps the glass heads first."""
    outputs = generate(net, inputs, base)
    if catalog_g is not None:
        outputs = snap_outputs_st(outputs, ol, catalog_g)
    return ol.unsupervised(inputs, outputs, stop_idx=1, engine=engine)[0]
