"""Training-loss bridge for neural lens-design generators.

PyTorch counterpart of ``torchoptics_tpu.loss``: decodes generated design
vectors (glass ``g`` pairs, curvatures, thicknesses), enforces EFL == 1 with
the algebraic last-curvature solve, builds a population of lenses, and
evaluates the unsupervised optical loss Lu = rms + rate·ΣQ of the whole
population at once: on kernel K2 (``engine="fused"``, one forward and one
backward launch per step) or on the pure-torch engine (``engine="unroll"``),
both with per-system semantics.

Sequence codes follow the JAX package: G -> '1', A -> '0', the digit string
read as an integer ("GAGA" -> 1010). The integer form drops leading 'A's, so
only sequences that start with 'G' are encoded; every generator lens type
(GA, GGA, GAGA) does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from torchoptics_tpu_torch import simulator as sim_mod
from torchoptics_tpu_torch.models import glass as glass_mod
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure
from torchoptics_tpu_torch.ops import abcd as abcd_mod

ENGINES = ("unroll", "fused")


def sequence_encoder(sequence: str) -> int:
    """'GAGA' -> 1010."""
    if not sequence or sequence[0] != "G":
        raise ValueError(
            f"encoded sequences must start with 'G' (got {sequence!r}); the "
            "integer encoding cannot represent a leading 'A'")
    return int("".join("1" if ch == "G" else "0" for ch in sequence))


def sequence_decoder(encoded: int) -> str:
    """1010 -> 'GAGA'."""
    return "".join("G" if d == "1" else "A" for d in str(int(encoded)))


def t_converter(stop_idx: int, sequence: str, t: torch.Tensor,
                as_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Splice the aperture-stop value into a parameter vector when the stop
    sits on an 'A' gap whose slot the generator does not emit. ``t`` is (L,)
    or a (B, L) batch, ``as_t`` a scalar or (B,); None means the design has
    no separate stop variable."""
    if as_t is None:
        return t
    as_t = torch.as_tensor(as_t, dtype=t.dtype, device=t.device)
    as_t = as_t.reshape(t.shape[:-1] + (1,))
    if sequence[stop_idx - 1] == "A":
        return torch.cat((t[..., : stop_idx - 1], as_t, t[..., stop_idx - 1:]), dim=-1)
    return t


@dataclass(frozen=True)
class OpticalLoss:
    """Optical loss for a neural lens-design generator, one instance per
    lens type. The defaults are the reference's loss-bridge scale: 8 fields
    x 8x8 circular pupil x 3 wavelengths = 1,536 rays per design, one
    ray-aiming iteration."""

    lens_type: str
    penalty_rate: float = 0.2
    n_sampled_fields: int = 8
    n_pupil_rings: int = 8
    wavelengths: Tuple[float, ...] = (459.0, 520.0, 640.0)
    pupil_sampling: str = "circular"
    n_ray_aiming_iter: int = 1
    # 'y' is the reference's Y-deviation-only spot RMS (parity default); 'xy'
    # the radial 2-D metric, which also sees sagittal blur: train on 'xy'.
    spot_metric: str = "y"

    @property
    def code_lenstype(self) -> int:
        return sequence_encoder(self.lens_type)

    @property
    def numsurf(self) -> int:
        return len(self.lens_type)

    @property
    def numglass(self) -> int:
        return sum(1 for ch in self.lens_type if ch == "G")

    @property
    def numin(self) -> int:
        return 2 + 2 * self.numsurf

    @property
    def numout(self) -> int:
        return 2 * self.numglass + 2 * self.numsurf - 1

    def _sim_config(self) -> sim_mod.SimulatorConfig:
        return sim_mod.SimulatorConfig(
            wavelengths=self.wavelengths,
            penalty_rate=self.penalty_rate,
            n_pupil_rings=self.n_pupil_rings,
            n_ray_aiming_iter=self.n_ray_aiming_iter,
            pupil_sampling=self.pupil_sampling,
            n_sampled_fields=self.n_sampled_fields,
            spot_metric=self.spot_metric,
        )

    def _decode(self, inputs: torch.Tensor, outputs: torch.Tensor, stop_idx: int,
                has_stop_vars: bool):
        """(epd, hfov, c without the last, t, n, v, full sequence) of one
        design vector (1-D) or of a batch of them (2-D): the reference's slot
        layout, with the stop variables spliced in first, so that the
        last-curvature solve sees full-length vectors (JAX's shape-consistent
        splice; the reference solves with the pre-splice thicknesses)."""
        G, S = self.numglass, self.numsurf
        sequence = self.lens_type
        epd, hfov = inputs[..., 0], inputs[..., 1]
        t = outputs[..., G * 2 + S - 1: self.numout]
        g = outputs[..., : 2 * G].reshape(outputs.shape[:-1] + (G, 2))
        n, v = glass_mod.n_v_from_g(g)
        c_wo_last = outputs[..., G * 2: G * 2 + S - 1]
        if has_stop_vars and sequence[stop_idx - 1] == "A":
            t = t_converter(stop_idx, sequence, t, inputs[..., -1])
            c_wo_last = t_converter(stop_idx, sequence, c_wo_last, inputs[..., -2])
            sequence = sequence[: stop_idx - 1] + "A" + sequence[stop_idx - 1:]
        return epd, hfov, c_wo_last, t, n, v, sequence

    def unsupervised_single(self, inputs: torch.Tensor, outputs: torch.Tensor,
                            stop_idx: int, has_stop_vars: bool = False,
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Loss of one (input, output) pair on the pure-torch engine, the
        per-sample function that ``build_batch`` is held against. Returns
        (loss_unsup, rms, penalty)."""
        epd, hfov, c_wo_last, t, n, v, sequence = self._decode(inputs, outputs, stop_idx,
                                                               has_stop_vars)
        structure = Structure((int(stop_idx),), (sequence,))
        c = abcd_mod.compute_last_curvature(structure, c_wo_last, t, n)
        lens = Lens(structure, c, t, n, v)
        specs = Specs(structure, epd.reshape(1), hfov.reshape(1))
        from torchoptics_tpu_torch.ops import trace as trace_mod
        res = trace_mod.trace_rays(specs, lens, self._sim_config().trace_config(),
                                   aggregate=trace_mod.AGG_TORCH)
        loss = sim_mod.compute_loss_out(res, len(sequence), self.penalty_rate,
                                        spot_metric=self.spot_metric)
        return loss["loss_unsup"], loss["rms"], loss["penalty"]

    def build_batch(self, inputs: torch.Tensor, outputs: torch.Tensor, stop_idx: int,
                    has_stop_vars: bool = False) -> Tuple[Specs, Lens]:
        """Decode a batch of design vectors, inputs (B, numin) and outputs
        (B, numout), into one (Specs, Lens) population: one Structure, EFL ==
        1 for every system."""
        epd, hfov, c_wo_last, t, n, v, sequence = self._decode(inputs, outputs, stop_idx,
                                                               has_stop_vars)
        B = inputs.shape[0]
        structure = Structure((int(stop_idx),) * B, (sequence,) * B)
        c = abcd_mod.compute_last_curvature(structure, c_wo_last.reshape(-1), t.reshape(-1),
                                            n.reshape(-1))
        lens = Lens(structure, c, t.reshape(-1), n.reshape(-1), v.reshape(-1))
        return Specs(structure, epd, hfov), lens

    def unsupervised(self, inputs: torch.Tensor, outputs: torch.Tensor,
                     stop_idx: Optional[int] = None, has_stop_vars: bool = False,
                     engine: str = "unroll", mesh=None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Mean unsupervised loss over a batch of designs, with the mean rms
        and penalty: the population of ``build_batch`` on kernel K2's Lu mode
        (``engine="fused"``) or on the pure-torch engine (``"unroll"``).

        With ``engine="fused"`` and a ``parallel.mesh.Mesh`` in ``mesh`` the
        population shards over the mesh's ('lens', 'rays') axes, one K2
        launch a rank on its block (``parallel.shard.sharded_fused_losses``):
        multi-GPU generator training. The network and its designs are
        replicated, and each rank's gradient is its block's share: sum the
        network's gradients over the world (``mesh.sum_gradients``) before
        the optimizer's step. The unroll engine ignores ``mesh``.

        ``stop_idx`` is a host int; it defaults to the value in the first
        sample's input slot -3 (every sample of one lens type shares it)."""
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if stop_idx is None:
            stop_idx = int(inputs[0, -3])
        specs, lens = self.build_batch(inputs, outputs, stop_idx, has_stop_vars)
        if engine == "fused" and mesh is not None:
            from torchoptics_tpu_torch.parallel import shard as shard_mod
            mean_lu, loss = shard_mod.sharded_fused_losses(specs, lens, self._sim_config(), mesh,
                                                           full=False)
            return mean_lu, loss["rms"], loss["penalty"]
        if engine == "fused":
            from torchoptics_tpu_torch.ops import fused_batch
            mean_lu, loss = fused_batch.batched_unsupervised_loss(specs, lens,
                                                                  self._sim_config())
            return mean_lu, torch.mean(loss["rms"]), torch.mean(loss["penalty"])
        _, loss = sim_mod.do_ray_tracing(specs, lens, self._sim_config())
        return loss["loss_unsup"], loss["rms"], loss["penalty"]

    def supervised(self, inputs: torch.Tensor, outputs: torch.Tensor) -> torch.Tensor:
        """Per-block MSE between generated and reference design vectors."""
        S, G = self.numsurf, self.numglass
        g1 = list(range(0, 2 * G, 2))
        g2 = list(range(1, 2 * G + 1, 2))
        c_st = G * 2
        t_st = G * 2 + S - 1
        dev_g1 = outputs[:, g1] - inputs[:, g1]
        dev_g2 = outputs[:, g2] - inputs[:, g2]
        dev_c = outputs[:, c_st: c_st + S - 1] - inputs[:, c_st: c_st + S - 1]
        dev_t = outputs[:, t_st: t_st + S] - inputs[:, t_st: t_st + S]
        sum_sq = (torch.sum(dev_g1 ** 2, 1) + torch.sum(dev_g2 ** 2, 1)
                  + torch.sum(dev_c ** 2, 1) + torch.sum(dev_t ** 2, 1))
        return torch.mean(sum_sq / (2 * G + 2 * S - 1))
