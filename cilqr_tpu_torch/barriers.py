"""Barrier functions for constraint costs (PyTorch counterpart of
cilqr_tpu/barriers.py).

Branchless: both branches are evaluated and ``torch.where`` picks one; the
relaxed-log barrier guards its log with ``min(x, -eps)`` so the unused
branch never produces a NaN. For a constraint g with gradient dx and
Hessian ddx,
    jac  = grad_factor(g) * dx
    hess = dxdx_factor(g) * dx dx^T + ddx_factor(g) * ddx
with the reference's quadratic-branch Hessian quirk
(barrier_function.h:135-139).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RelaxBarrier:
    t: float = 5.0
    epsilon: float = 0.01

    def value(self, x):
        """barrier_function.h:104-113."""
        rt = 1.0 / self.t
        eps = self.epsilon
        safe_x = torch.clamp(x, max=-eps)
        log_branch = -rt * torch.log(-safe_x)
        quad_branch = (0.5 * rt * (((-x - 2.0 * eps) / eps) ** 2 - 1.0)
                       - rt * math.log(eps))
        return torch.where(x < -eps, log_branch, quad_branch)

    def grad_factor(self, x):
        """Scalar multiplying dx in the Jacobian (barrier_function.h:115-125)."""
        rt = 1.0 / self.t
        eps = self.epsilon
        safe_x = torch.clamp(x, max=-eps)
        log_branch = -rt / safe_x
        quad_branch = rt * (x + 2.0 * eps) / (eps * eps)
        return torch.where(x < -eps, log_branch, quad_branch)

    def hess_factors(self, x):
        """(dxdx_factor, ddx_factor) (barrier_function.h:127-140)."""
        rt = 1.0 / self.t
        eps = self.epsilon
        safe_x = torch.clamp(x, max=-eps)
        log_dxdx = rt / (safe_x * safe_x)
        log_ddx = -rt / safe_x
        quad_dxdx = rt * (x + 2.0 * eps) / (eps * eps)
        in_log = x < -eps
        return (torch.where(in_log, log_dxdx, quad_dxdx),
                torch.where(in_log, log_ddx, torch.zeros_like(x)))


@dataclasses.dataclass(frozen=True)
class ExponentialBarrier:
    """q1*exp(q2*x), clipped to 0 below q1 (barrier_function.h:37-79)."""

    q1: float = 0.5
    q2: float = 2.5

    def value(self, x):
        c = self.q1 * torch.exp(self.q2 * x)
        return torch.where(c < self.q1, torch.zeros_like(c), c)

    def grad_factor(self, x):
        active = self.value(x) >= 1e-10
        return torch.where(active, self.q1 * self.q2 * torch.exp(self.q2 * x),
                           torch.zeros_like(x))

    def hess_factors(self, x):
        active = self.value(x) >= 1e-10
        e = torch.exp(self.q2 * x)
        z = torch.zeros_like(x)
        return (torch.where(active, self.q1 * self.q2 * self.q2 * e, z),
                torch.where(active, self.q1 * self.q2 * e, z))


@dataclasses.dataclass(frozen=True)
class QuadraticBarrier:
    """1000*x^2 penalty for x>0 (barrier_function.h:149-189), with the
    reference's constant-gradient quirk (barrier_function.h:170)."""

    param: float = 1000.0

    def value(self, x):
        return torch.where(x < 1e-10, torch.zeros_like(x), self.param * x * x)

    def grad_factor(self, x):
        return torch.where(x < 1e-10, torch.zeros_like(x),
                           torch.full_like(x, 2.0 * self.param))

    def hess_factors(self, x):
        return self.grad_factor(x), torch.zeros_like(x)


def make_barrier(cfg):
    """Barrier selected by BarrierConfig.kind. The CUDA cost-stack kernel
    hardcodes relax semantics, so other kinds take the plain cost stack
    (solver_blast._use_coststack_kernel gates on kind)."""
    kind = cfg.kind
    if kind == "relax":
        return RelaxBarrier(cfg.t, cfg.epsilon)
    if kind == "exponential":
        return ExponentialBarrier(cfg.exp_q1, cfg.exp_q2)
    if kind == "quadratic":
        return QuadraticBarrier(cfg.quad_param)
    raise ValueError(f"unknown barrier kind {kind!r} "
                     "(expected relax | exponential | quadratic)")
