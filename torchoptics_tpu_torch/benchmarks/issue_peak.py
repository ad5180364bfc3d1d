#!/usr/bin/env python3
"""P1: the issue rate of the card's FP32 pipes, measured.

The PyTorch / CUDA counterpart of ``benchmarks/vpu_peak.py`` (the JAX
package's TPU vector-unit probe). Kernel P1 (``csrc/issue_peak.cu``) runs
NACC = 8 independent chains per thread of one of three steps for ``iters``
iterations, on a grid that fills the card:

* ``fma``:  a = fmaf(a, k1, k2), one fused multiply-add;
* ``sqrt``: a = sqrtf(a) + k2, the IEEE square root the trace kernels use;
* ``div``:  a = k1 / a + k2, IEEE division.

Protocol, as ``vpu_peak.py``'s: each timed launch runs ~150 ms (the
iteration count is scaled from a short calibration launch); the rate is the
minimum time over repeats, timed with CUDA events (every interference only
slows a run down); the result is lane-operations per second for each op,
and ``sqrt_weight`` and ``div_weight``, the cost of one sqrt or division
step in fma steps (each step also carries an add, so the weights slightly
over-count: conservative for a bound).

:func:`chains` is the kernel's wrapper (its plain version
:func:`chains_reference` on a CPU tensor) and :func:`measure_issue` the
protocol, which needs a card::

    python -m torchoptics_tpu_torch.benchmarks.issue_peak   # one JSON line
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

#: Launches of kernel P1 in this process; reset to 0 to count one run's.
P1_LAUNCHES = 0

OPS = ("fma", "sqrt", "div")
NACC = 8
K1 = np.float32(1.0000001)
K2 = np.float32(1e-7)
#: Start multipliers of the accumulators, float32(1 + 1e-7 k).
SCALES = np.asarray([1.0 + 1e-7 * k for k in range(NACC)], dtype=np.float32)
#: Blocks of 256 threads per SM in the probe's grid.
BLOCKS_PER_SM = 8
TARGET_MS = 150.0
REPS = 5


def fmaf_reference(a: torch.Tensor, k1: float, k2: float) -> torch.Tensor:
    """float32 ``fmaf(a, k1, k2)``, rounded once, in float64 arithmetic: the
    product of two float32 values is exact in float64; the float64 sum is
    rounded to odd (its TwoSum error moves an inexact even result to its odd
    neighbour), and a sum rounded to odd with 53 >= 24 + 2 bits rounds to
    float32 as the exact sum would (Boldo and Melquiond, 2008)."""
    p = a.double() * float(k1)
    k2 = float(k2)
    t = p + k2
    bv = t - p
    err = (p - (t - bv)) + (k2 - bv)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.full_like(t, float("inf")).copysign(err)
    return torch.where((err != 0) & even, torch.nextafter(t, toward), t).float()


def chains_reference(x: torch.Tensor, op: str, iters: int, fused: bool = True) -> torch.Tensor:
    """Plain version of kernel P1: the same chains, elementwise, rounding as
    the kernel does. The fma step is :func:`fmaf_reference`; with
    ``fused=False`` it is ``a * k1 + k2``, rounded twice, the chain an
    unfused multiply and add would give (it differs from the fused chain on
    a few percent of the lanes at 16 steps)."""
    k1 = torch.tensor(K1, device=x.device)
    k2 = torch.tensor(K2, device=x.device)
    accs = [x * torch.tensor(s, device=x.device) for s in SCALES]
    for _ in range(iters):
        if op == "fma":
            accs = [fmaf_reference(a, K1, K2) if fused else a * k1 + k2 for a in accs]
        elif op == "sqrt":
            accs = [torch.sqrt(a) + k2 for a in accs]
        elif op == "div":
            accs = [k1 / a + k2 for a in accs]
        else:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def _launch_p1(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    global P1_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"P1 takes a contiguous 1-D float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    scale = torch.tensor(SCALES, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.p1_chain_launch(x.data_ptr(), scale.data_ptr(), float(K1), float(K2),
                                  int(iters), x.shape[0], OPS.index(op), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"P1 (issue-rate probe) launch failed: "
                           f"{lib.k1_error_string(err).decode()}")
    P1_LAUNCHES += 1
    return out


def chains(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """Kernel P1 on a CUDA tensor, :func:`chains_reference` on a CPU one."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.device.type == "cpu":
        return chains_reference(x, op, iters)
    if x.device.type != "cuda":
        raise ValueError(f"P1 runs on CUDA or CPU tensors, got {x.device}")
    return _launch_p1(x, op, iters)


def probe_threads() -> int:
    """The probe's thread count: BLOCKS_PER_SM blocks of 256 on every SM of
    the current card."""
    return torch.cuda.get_device_properties(0).multi_processor_count * BLOCKS_PER_SM * 256


def _launch_ms(x, op, iters, reps):
    """Minimum milliseconds of one launch over ``reps``, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chains(x, op, iters)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def measure_issue() -> Dict:
    """The protocol, on the current card: for each op, a calibration launch
    of 2^14 iterations sets the iteration count of a ~TARGET_MS launch;
    after a warm-up, the minimum of REPS timed launches gives the rate.
    Returns the lane-operations per second of each op, the weights of sqrt
    and div against fma, and what was run."""
    if not torch.cuda.is_available():
        raise RuntimeError("the issue-rate probe measures a CUDA device; none is available")
    n = probe_threads()
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    out: Dict = {"threads": n, "nacc": NACC, "protocol": "min of %d launches of ~%.0f ms, "
                 "CUDA events" % (REPS, TARGET_MS), "device": torch.cuda.get_device_name(0)}
    per_iter = {}
    for op in OPS:
        calib = 1 << 14
        chains(x, op, calib)
        ms = _launch_ms(x, op, calib, 2)
        iters = max(calib, int(calib * TARGET_MS / ms))
        chains(x, op, iters)
        ms = _launch_ms(x, op, iters, REPS)
        per_iter[op] = ms / iters
        out[f"{op}_iters"] = iters
        out[f"{op}_ms"] = ms
        out[f"{op}_ops_per_s"] = n * NACC * iters / (ms * 1e-3)
    for op in ("sqrt", "div"):
        out[f"{op}_weight"] = per_iter[op] / per_iter["fma"]
    return out


if __name__ == "__main__":
    print(json.dumps(measure_issue()))
