"""The control: the reference computed in the precision below the one the
configuration states. The configurations state bf16 compute, so the step below
is fp8: inside ``Fp8Mode`` every operand of a matrix product or convolution
(``linear``, ``conv2d``, ``matmul``/``@``, ``mm``, ``bmm``, ``addmm``,
``baddbmm``, ``einsum``) is rounded to float8 e4m3 with one scale a tensor (its
largest magnitude onto 448, e4m3's largest), as an fp8 path stores them; the
product itself and everything else stay in f32. Gradients pass the rounding
unchanged (straight through), as an fp8 training path's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    if not (torch.is_tensor(x) and x.is_floating_point()) or x.numel() == 0:
        return x
    with torch.no_grad():
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = amax / E4M3_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float().mul_(scale).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


_FUNCS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
          torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.addmm, torch.baddbmm,
          torch.Tensor.mm, torch.Tensor.bmm}


class Fp8Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FUNCS:
            args = tuple(fp8_round(a) for a in args)
            kwargs = {k: fp8_round(v) for k, v in kwargs.items()}
        elif func is torch.einsum:
            eq, *ops = args
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = list(ops[0])
            args = (eq, *[fp8_round(o) for o in ops])
        return func(*args, **kwargs)
