"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: without a CUDA device every test skips (a CUDA kernel has
no CPU mode). The module imports neither JAX nor the JAX package, so it runs
on a machine with the card but without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

K1 forward is built without FMA contraction and must agree with its plain
version bit for bit on coordinates and masks; the Lu penalty sums within
1e-5 (acosf rounding, measured <= 2e-6 on an H100).
"""

import pytest
import torch

from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.ops import fused_trace

pytestmark = pytest.mark.cuda

CONFIG = dict(n_sampled_fields=16, n_pupil_rings=96, pupil_sampling="circular",
              n_ray_aiming_iter=1)
MODES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
@pytest.mark.parametrize("penalties,allow_backward", MODES)
def test_k1_forward_matches_plain_version(cuda, c_scale, penalties, allow_backward):
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    specs, lens = zoo.build("double_gauss", device=cuda)
    lens = lens.replace(c=lens.c * c_scale)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_trace.prepare_fused_inputs(
            specs, lens, cfg)
        args = (xp, yp, cyb, z0, lens.c[0], lens.t[0], mu)
        before = fused_trace.K1_FWD_LAUNCHES
        got = fused_trace.trace_fused(*args, penalties, allow_backward, F * P)
        want = fused_trace.trace_fused_reference(*args, penalties, allow_backward, F * P)
        torch.cuda.synchronize()
    assert fused_trace.K1_FWD_LAUNCHES == before + 1
    assert len(got) == len(want) == (9 if penalties else 6)
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a, b)
    for a, b in zip(got[6:], want[6:]):
        assert float((a - b).abs().max()) <= 1e-5
    if c_scale == 3.0:
        assert 0 < float(got[4].float().mean()) < 1


def test_k1_forward_refuses_bad_inputs(cuda):
    x = torch.zeros(8, device=cuda)
    c = torch.zeros(3, device=cuda)
    mu = torch.ones(3, 2, device=cuda)
    z0 = torch.zeros((), device=cuda)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            fused_trace.trace_fused(x.double(), x, x, z0, c, c, mu, False, True, 4)
        with pytest.raises(ValueError, match="contiguous"):
            fused_trace.trace_fused(torch.zeros(16, device=cuda)[::2], x, x, z0, c, c, mu,
                                    False, True, 4)
        with pytest.raises(ValueError, match="surfaces"):
            fused_trace.trace_fused(x, x, x, z0, torch.zeros(65, device=cuda),
                                    torch.zeros(65, device=cuda), torch.ones(65, 2, device=cuda),
                                    False, True, 4)
        with pytest.raises(ValueError, match="is on"):
            fused_trace.trace_fused(x, x, x, z0.cpu(), c, c, mu, False, True, 4)
    c_grad = c.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        fused_trace.trace_fused(x, x, x, z0, c_grad, c, mu, False, True, 4)


def test_fused_loss_on_gpu_matches_cpu(cuda):
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused")
    specs, lens = zoo.build("double_gauss", device=cuda)
    with torch.no_grad():
        _, loss = simulator.do_ray_tracing(specs, lens, cfg)
        _, want = simulator.do_ray_tracing(specs.to("cpu"), lens.to("cpu"), cfg)
    for key, rtol in (("loss_unsup", 1e-5), ("penalty", 1e-5), ("rms", 2e-4)):
        assert abs(float(loss[key]) - float(want[key])) <= rtol * abs(float(want[key])), key
