"""Fixture kernels with deliberately broken launch contracts.

Exposes ``kernel_cases()`` for ``python -m repro_torch.analysis
--kernels-from`` (and direct use from tests): each case trips exactly one
KC2xx check.  Cases yield (name, CUDA wrapper, meta args, kwargs[, plain
twin]); ``launch_plan`` gives the fixture kernels' geometry and defers to
the registry's for real kernels.
"""
import torch

from repro_torch.kernels import ops


def launch_plan(name, *int_args):
    if name == "half_grid":
        (n,) = int_args      # ceil(n / 256) blocks of 128 rows: half the rows
        return (ops.LaunchPlan((-(-n // 256), 1, 1), (128, 1, 1), 0,
                               (ops.Cover("rows", 0, 128, n),)),)
    if name == "smem_blowout":
        (n,) = int_args      # 256 KiB of dynamic shared memory a block
        return (ops.LaunchPlan((-(-n // 256), 1, 1), (256, 1, 1), 256 * 1024,
                               (ops.Cover("rows", 0, 256, n),)),)
    return ops.launch_plan(name, *int_args)


def _fake_wrapper(name):
    def wrapper(x):
        out = torch.empty_like(x)
        ops._launch(name, "fixture", x.device, x.shape[0])
        return out
    return wrapper


def no_launch(x):
    """Computes on the host side of the wrapper: no kernel is launched."""
    return x * 2


def morton_int32_codes(y, cent, r_span, depth=16):
    """A plain twin returning the TPU kernel's int32 codes (the port's are int64)."""
    return torch.empty((y.shape[0],), dtype=torch.int32, device=y.device)


def kernel_cases():
    def meta(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    yield "no_launch", no_launch, (meta(1000, 2),), {}
    yield "half_grid", _fake_wrapper("half_grid"), (meta(1000, 2),), {}
    # 2^31 + 8 points: n wraps to a negative c_int and the C entry launches nothing
    yield ("morton_past_int32", ops.morton_encode_cuda,
           (meta(2**31 + 8, 2), meta(2), meta()), {})
    yield ("morton_int32_twin", ops.morton_encode_cuda, (meta(1000, 2), meta(2), meta()),
           {}, morton_int32_codes)
    yield "smem_blowout", _fake_wrapper("smem_blowout"), (meta(1000, 2),), {}
