"""The flags and checks that every example shares: ``--engine`` and
``--device``."""

import torch

ENGINE_HELP = ("trace engine: fused (the hand-written kernels; the default on the GPU) or "
               "unroll (pure torch; the default on the CPU)")


def add_device_arguments(ap, engine_help: str = ENGINE_HELP) -> None:
    ap.add_argument("--engine", default=None, choices=(None, "fused", "unroll"),
                    help=engine_help)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def resolve_engine(args) -> str:
    """The engine the example runs on. Raises when ``--device`` names a GPU
    that this machine lacks: an example never falls back to the CPU."""
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} needs a CUDA device; pass --device cpu "
                           "to run on the CPU")
    return args.engine or ("unroll" if args.device == "cpu" else "fused")


def p2_route_line(img_hw, config) -> str:
    """Which of P2's routes a render of ``img_hw`` pixels takes, forward
    and d/dpsf: the route goes by the patch PSFs' taps, the configured PSF
    resized to the image's pixel pitch (``imaging.psf_kernel_shape``)."""
    from torchoptics_tpu_torch import imaging
    from torchoptics_tpu_torch.ops import image as image_mod
    k = imaging.psf_kernel_shape(tuple(img_hw), config)
    route = lambda adjoint: "FFT" if image_mod.p2_takes_fft(k, adjoint) else "direct"
    return (f"P2 route: {route(False)} forward, {route(True)} d/dpsf ({k[0]} x {k[1]} patch "
            f"PSFs: the {config.psf_shape[0]} x {config.psf_shape[1]} PSF at "
            f"{img_hw[0]}x{img_hw[1]} px)")
