"""The rigid cycle's Newton step on PyTorch/CUDA: the Tikhonov-regularized 6x6 solve
and pose update of every body as one hand-written Hopper kernel
(``csrc/newton_kernels.cu``) per step.

:func:`newton_step` launches the kernel for CUDA tensors and runs its plain PyTorch twin
:func:`newton_step_plain` for CPU tensors; there is no fallback from one to the other.
The JAX package has no kernel here (XLA fuses its ``pipeline._solve_and_update`` into
the jitted cycle); the plain twin is that function's arithmetic, some 236 elementwise
kernels over the batch, which the kernel does in registers in the same order.
"""

from __future__ import annotations

import torch

from m3t_tpu_torch.common import pose_variation
from m3t_tpu_torch.ops import _cuda
from m3t_tpu_torch.ops._cuda import require as _require


def _ldlt_solve_6x6(a, b):
    """Unrolled batched LDLT solve for symmetric 6x6 systems: a (B, 6, 6), b (B, 6).

    The Tikhonov-regularized system is symmetric positive definite, so the reference's
    LDLT (optimizer.cpp:162-163) applies; every operation is elementwise over the batch.
    """
    n = 6
    low = [[None] * n for _ in range(n)]
    diag = [None] * n
    for j in range(n):
        s = a[:, j, j]
        for k in range(j):
            s = s - low[j][k] * low[j][k] * diag[k]
        diag[j] = s
        for i in range(j + 1, n):
            t = a[:, i, j]
            for k in range(j):
                t = t - low[i][k] * low[j][k] * diag[k]
            low[i][j] = t / s
    y = [None] * n
    for i in range(n):
        t = b[:, i]
        for k in range(i):
            t = t - low[i][k] * y[k]
        y[i] = t
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i] / diag[i]
        for k in range(i + 1, n):
            t = t - low[k][i] * x[k]
        x[i] = t
    return torch.stack(x, dim=1)


def _check_inputs(gradient, hessian, pose):
    _require(all(t.dtype == torch.float32 for t in (gradient, hessian, pose)),
             "newton_step inputs must be float32")
    _require(gradient.dim() == 2 and gradient.shape[1] == 6, "gradient must be (B, 6)")
    b = gradient.shape[0]
    _require(hessian.shape == (b, 6, 6), "hessian must be (B, 6, 6)")
    _require(pose.shape == (b, 4, 4), "pose must be (B, 4, 4)")
    _require(all(t.is_contiguous() for t in (gradient, hessian, pose)),
             "newton_step inputs must be contiguous")
    devices = {gradient.device, hessian.device, pose.device}
    _require(len(devices) == 1, f"inputs on different devices: {devices}")


def newton_step_plain(gradient, hessian, pose, tikhonov_rotation: float,
                      tikhonov_translation: float):
    """Plain PyTorch twin of the newton_step kernel (same arithmetic, same order)."""
    _check_inputs(gradient, hessian, pose)
    # Filled on the device (no host-to-device copy), as the articulated step does.
    diagonal = torch.full((6,), tikhonov_rotation, dtype=torch.float32,
                          device=pose.device)
    diagonal[3:] = tikhonov_translation
    a = -hessian + torch.diag(diagonal)[None, :, :]
    theta = _ldlt_solve_6x6(a, gradient)
    theta = torch.where(torch.isnan(theta).any(dim=-1, keepdim=True),
                        torch.zeros_like(theta), theta)
    # Single root link with identity body2joint: pose' = pose @ variation
    # (link.cpp:236-238 with body2joint == I).
    return pose @ pose_variation(theta)


@_cuda.kernel("m3t_newton_step",
              [_cuda.PTR] * 4 + [_cuda.INT, _cuda.FLOAT, _cuda.FLOAT])
def newton_step(gradient, hessian, pose, tikhonov_rotation: float,
                tikhonov_translation: float):
    """Batched Tikhonov-regularized Newton step (optimizer.cpp:144-167, single link).

    gradient (B, 6), hessian (B, 6, 6) and pose (B, 4, 4), float32 and contiguous:
    theta solves (diag(rotation x 3, translation x 3) - hessian) theta = gradient (0
    where any entry is NaN); returns pose @ pose_variation(theta) as a new (B, 4, 4).
    """
    if pose.device.type == "cpu":
        return newton_step_plain(gradient, hessian, pose, tikhonov_rotation,
                                 tikhonov_translation)
    _check_inputs(gradient, hessian, pose)
    _require(pose.device.type == "cuda", f"unsupported device {pose.device}")
    b = pose.shape[0]
    out = torch.empty((b, 4, 4), dtype=torch.float32, device=pose.device)
    if b == 0:
        return out
    _cuda.launch("m3t_newton_step", pose.device, gradient.data_ptr(), hessian.data_ptr(),
                 pose.data_ptr(), out.data_ptr(), b, tikhonov_rotation,
                 tikhonov_translation)
    return out
