"""Numerical debugging: NaN policing and trace health reports.

PyTorch counterpart of ``torchoptics_tpu.utils.debugging``. Where the JAX
package wraps a function in ``checkify``, the port watches every operation
the function dispatches (a ``TorchDispatchMode``) and raises at the first
that produces a NaN or divides by zero; ``trace_health`` summarizes the
failure bookkeeping the engines already keep.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ops = torch.ops.aten
#: Operations whose outputs are uninitialized or need not be looked at.
_UNCHECKED = {_ops.empty.memory_format, _ops.empty_strided.default, _ops.empty_like.default,
              _ops.new_empty.default, _ops.new_empty_strided.default}
#: Divisions: (operation, position of the divisor).
_DIVISIONS = {_ops.div.Tensor, _ops.div.Scalar, _ops.div.Tensor_mode, _ops.div.Scalar_mode,
              _ops.div_.Tensor, _ops.div_.Scalar, _ops.remainder.Tensor, _ops.remainder.Scalar,
              _ops.floor_divide.default, _ops.fmod.Tensor, _ops.fmod.Scalar,
              _ops.reciprocal.default}


class _Checks(TorchDispatchMode):
    def __init__(self, nan: bool, div: bool):
        super().__init__()
        self.nan, self.div = nan, div

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.div and func in _DIVISIONS:
            divisor = args[0] if func is _ops.reciprocal.default else args[1]
            if bool(torch.as_tensor(divisor).eq(0).any()):
                raise ZeroDivisionError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if self.nan and func not in _UNCHECKED:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN produced by {func}")
        return out


def checked(fn: Callable, *, nan: bool = True, div: bool = True) -> Callable:
    """Wrap ``fn`` so that it raises at the first operation inside it that
    produces a NaN (``FloatingPointError``) or divides by zero
    (``ZeroDivisionError``), naming that operation; the port's stand-in for
    the JAX package's ``checkify`` wrapper.

    Returns a function with the same signature. Every operation is checked
    as it runs, a device synchronization each: a debugging tool, not for
    timed runs. The hand-written CUDA kernels, launched through ctypes, are
    checked at their outputs only: what they write is seen where a later
    operation reads it. A backward run inside ``fn`` is checked too.

    Example::

        safe_loss = debugging.checked(loss_fn)
        value = safe_loss(lens)          # raises FloatingPointError on NaN
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _Checks(nan, div):
            return fn(*args, **kwargs)

    return wrapped


def trace_health(result) -> Dict[str, torch.Tensor]:
    """Summarize a ``TraceResult``'s failure bookkeeping: the metrics the
    reference logged as ray_tracing/*."""
    ok = result.ray_ok
    return {
        "ray_failures": torch.sum(~ok),
        "ray_failure_fraction": torch.mean((~ok).to(torch.float32)),
        "backward_rays": torch.sum(result.ray_backward),
        "nonfinite_coords": (torch.sum(~torch.isfinite(result.x))
                             + torch.sum(~torch.isfinite(result.y))),
    }
