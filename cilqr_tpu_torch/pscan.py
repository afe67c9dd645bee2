"""Horizon-parallel Riccati backward pass (PyTorch counterpart of
cilqr_tpu/pscan.py), batch-first; ``IlqrConfig.backward_backend="pscan"``
selects it in the single-problem solver.

The reference's backward sweep walks the knots one at a time
(ilqr_optimizer.cc:334-390). The Riccati recursion also has a
parallel-prefix form ("The Parallelization of Riccati Recursion", arXiv
1809.06360; "Temporal Parallelization of Dynamic Programming and LQT",
arXiv 2104.03186): each step is a map e = (Phi, b, C, eta, J) of the next
knot's value function (v, M),

    M_out = J + Phi^T M (I + C M)^-1 Phi
    v_out = eta + Phi^T (I + M C)^-1 (v + M b),

with R = Hu + lam I, C = B R^-1 B^T, b = -B R^-1 Ju, Phi = A, eta = Jx,
J = Hx, and the family is closed under composition (``_combine``).
Composing every suffix e_k o ... o e_T (e_T the terminal cost, a constant
map) gives V[k] at every knot in O(log T) depth; the gains are then
computed pointwise, as in the sequential sweep.

The value function is propagated with the REGULARIZED gains (the
Woodbury placement); the reference's sweep propagates it with the
unregularized Quu, an extra O(lam) term outside the associative family.
The two coincide at lam = 0; ``backward_pass_woodbury_seq`` is the
sequential sweep with this module's placement, which the scan must equal
at any lam up to the order of its sums.

The scan is written out as plain tensor operations: the odd/even
recursion of ``jax.lax.associative_scan`` (pair neighbours, scan the
pairs, fill in the even positions), 7 levels over the 81 elements of an
80-step horizon. Its combine solves 6x6 systems with
``torch.linalg.solve``, so it is not bit-identical to the JAX package's.
"""

from __future__ import annotations

import torch

from .solver import _inv22


def _mv(M, v):
    """Batched matrix-vector product over leading axes."""
    return (M @ v[..., None])[..., 0]


def _elements(lam, A, B, Jx, Ju, Hx, Hu):
    """Per-step elements (Phi, b, C, eta, J), each [Bt, T+1, ...] in time
    order k = 0..T with the terminal element last. lam [Bt]; A [Bt, T, 6,
    6], B [Bt, T, 6, 2]; Jx, Hx [Bt, T+1, ...]; Ju, Hu [Bt, T, ...]."""
    eye2 = torch.eye(2, dtype=A.dtype, device=A.device)
    R = Hu + lam[:, None, None, None] * eye2
    BRinv = B @ _inv22(R)                               # [Bt, T, 6, 2]
    C = BRinv @ B.mT                                    # B R^-1 B^T
    b = -_mv(BRinv, Ju)
    zero_m = torch.zeros_like(A[:, :1])
    return (torch.cat([A, zero_m], dim=1),              # Phi
            torch.cat([b, torch.zeros_like(b[:, :1])], dim=1),
            torch.cat([C, zero_m], dim=1),
            Jx,                                         # eta
            Hx)                                         # J


def _combine(later, earlier):
    """e_c = e_earlier o e_later, elementwise over leading axes; ``later``
    is the operand nearer the terminal. With D = (I + C_a J_b)^-1:
    Phi_c = Phi_b D Phi_a, C_c = C_b + Phi_b D C_a Phi_b^T,
    J_c = J_a + Phi_a^T J_b D Phi_a, b_c = b_b + Phi_b D (b_a - C_a eta_b),
    eta_c = eta_a + Phi_a^T D^T (eta_b + J_b b_a)."""
    Pl, bl, Cl, el, Jl = later
    Pa, ba, Ca, ea, Ja = earlier
    n = Pl.shape[-1]
    eye = torch.eye(n, dtype=Pl.dtype, device=Pl.device)
    G = eye + Ca @ Jl                                   # I + C_a J_b
    # one system, three right-hand sides: D Phi_a, D C_a, D (b_a - C_a eta_b)
    rhs = torch.cat([Pa, Ca, (ba - _mv(Ca, el))[..., None]], dim=-1)
    sol = torch.linalg.solve(G, rhs)
    DPa = sol[..., :n]
    DCa = sol[..., n:2 * n]
    Dba = sol[..., 2 * n]
    # D^T (eta_b + J_b b_a), through the transposed system
    etJb = torch.linalg.solve(G.mT, (el + _mv(Jl, ba))[..., None])[..., 0]
    return (Pl @ DPa,
            bl + _mv(Pl, Dba),
            Cl + Pl @ DCa @ Pl.mT,
            ea + _mv(Pa.mT, etJb),
            Ja + Pa.mT @ Jl @ DPa)


def _scan(elems):
    """Inclusive scan along axis 1 with ``_combine(prefix, next)``: out[i]
    composes elems[0..i]. The odd/even recursion: combine neighbouring
    pairs, scan the pairs (every odd position), then each even position is
    the odd result before it combined with its own element."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _scan(_combine([e[:, 0:-1:2] for e in elems],
                         [e[:, 1::2] for e in elems]))
    prev = odd if n % 2 else [e[:, :-1] for e in odd]
    even = _combine(prev, [e[:, 2::2] for e in elems])
    out = []
    for e0, ev, od in zip(elems, even, odd):
        ev = torch.cat([e0[:, :1], ev], dim=1)          # [Bt, ceil(n/2)]
        full = torch.empty((e0.shape[0], n) + e0.shape[2:], dtype=e0.dtype,
                           device=e0.device)
        full[:, 0::2] = ev
        full[:, 1::2] = od
        out.append(full)
    return out


def value_functions(lam, A, B, Jx, Ju, Hx, Hu):
    """The value function at every knot in O(log T) depth: (Vx [Bt, T+1,
    6], Vxx [Bt, T+1, 6, 6]) for k = 0..T."""
    elems = _elements(lam, A, B, Jx, Ju, Hx, Hu)
    # reversed, so that the scan starts from the terminal and its prefix
    # operand is the LATER element in time
    out = _scan([torch.flip(e, dims=(1,)) for e in elems])
    # out[i] composes e_T .. e_{T-i}; e_T is constant, so the composed map
    # ignores its input and V_{T-i} = (eta_i, J_i)
    return torch.flip(out[3], dims=(1,)), torch.flip(out[4], dims=(1,))


def backward_pass_pscan(lam, A, B, Jx, Ju, Hx, Hu):
    """solver.backward_pass through the parallel scan: the same (Ks [Bt, T,
    2, 6], ks [Bt, T, 2], dV0 [Bt], dV1 [Bt]), the gains computed pointwise
    from the scanned value functions with the sequential sweep's formulas
    (the module docstring gives the one O(lam) difference)."""
    Vx, Vxx = value_functions(lam, A, B, Jx, Ju, Hx, Hu)
    Vx_n = Vx[:, 1:]                                     # V_{k+1}
    Vxx_n = Vxx[:, 1:]
    Qu = Ju + _mv(B.mT, Vx_n)
    BtV = B.mT @ Vxx_n
    Quu = Hu + BtV @ B
    Qux = BtV @ A
    eye2 = torch.eye(2, dtype=A.dtype, device=A.device)
    Rinv = _inv22(Quu + lam[:, None, None, None] * eye2)
    Ks = -(Rinv @ Qux)
    ks = -_mv(Rinv, Qu)
    dV0 = (ks * Qu).sum(dim=(1, 2))
    dV1 = 0.5 * (ks * _mv(Quu, ks)).sum(dim=(1, 2))
    return Ks, ks, dV0, dV1


def backward_pass_woodbury_seq(lam, A, B, Jx, Ju, Hx, Hu):
    """The sequential sweep with the pscan backend's value propagation
    (Woodbury, fully regularized): backward_pass_pscan equals it at any
    lam up to the order of its sums."""
    T = A.shape[1]
    eye2 = torch.eye(2, dtype=A.dtype, device=A.device)
    lam_i = lam[:, None, None] * eye2
    Vx = Jx[:, -1]
    Vxx = Hx[:, -1]
    dV0 = torch.zeros_like(lam)
    dV1 = torch.zeros_like(lam)
    Ks = [None] * T
    ks = [None] * T
    for t in range(T - 1, -1, -1):
        Ai, Bi = A[:, t], B[:, t]
        Qx = Jx[:, t] + _mv(Ai.mT, Vx)
        Qu = Ju[:, t] + _mv(Bi.mT, Vx)
        Qxx = Hx[:, t] + Ai.mT @ Vxx @ Ai
        Quu = Hu[:, t] + Bi.mT @ Vxx @ Bi
        Qux = Bi.mT @ Vxx @ Ai
        Rinv = _inv22(Quu + lam_i)
        K = -(Rinv @ Qux)
        k = -_mv(Rinv, Qu)
        Vx = Qx + _mv(Qux.mT, k)                     # Qx - Qux^T R^-1 Qu
        Vxx = Qxx + Qux.mT @ K                       # Qxx - Qux^T R^-1 Qux
        Vxx = 0.5 * (Vxx + Vxx.mT)
        dV0 = dV0 + (k * Qu).sum(dim=-1)
        dV1 = dV1 + 0.5 * (k * _mv(Quu, k)).sum(dim=-1)
        Ks[t], ks[t] = K, k
    return torch.stack(Ks, dim=1), torch.stack(ks, dim=1), dV0, dV1
