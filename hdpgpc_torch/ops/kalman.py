"""Kalman filter / RTS smoother primitives for the iterative GP
(counterpart of hdpgpc_tpu.ops.kalman).

Semantics mirror the reference's IterativeGaussianProcess
(GPI.py:72-151 ``posterior``, :240-300 ``backward``) on the shared grid
(the GP cross-covariance projection is the identity):

* prediction: m = A f,  P = A P A' + Gamma
* FIRST step special case: P = K, predicted obs = 0, innovation
  covariance = white-noise * I / h   (GPI.py:136-139)
* gain solved right-to-left: K = P C' (C P C' + R)^-1 (GPI.py:145-146)
* Joseph-form covariance update (GPI.py:149-150)

Every function broadcasts over leading (job) dimensions; ``first`` is a
bool tensor of the leading shape.

The associative-scan forms (kalman.py:111-261: ``parallel_filter``,
``parallel_filter_masked``, ``parallel_smooth``) compose the parallel
Kalman elements of Sarkka & Garcia-Fernandez (2021) with
ops/scan.associative_scan, JAX's even/odd recursion, so the elements are
composed in the reference's order. The time axis leads; the parameters
may carry batch dims that follow it (the frozen-cluster classifier runs
its K clusters as one batch). The elements' SPD solves go through
ops/spd_solve.spd_solve (kernel B on a CUDA tensor), with no jitter, as
the reference's ``solve_spd_t`` and ``cho_solve`` add none; the general
solves of ``_combine`` (the reference's ``solve_general``, an LU solve
off the TPU) are ``torch.linalg.solve_ex``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hdpgpc_torch.ops import linalg
from hdpgpc_torch.ops.scan import associative_scan
from hdpgpc_torch.ops.spd_solve import spd_solve


class LDSParams(NamedTuple):
    A: torch.Tensor       # (..., T, T)
    Gamma: torch.Tensor
    C: torch.Tensor
    Sigma: torch.Tensor


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def kalman_step(f, P, y, params: LDSParams, first, noise_first, h=1.0):
    """One filter update. f (..., T, 1), P (..., T, T), y (..., T, 1);
    ``first`` (...) bool; ``noise_first`` (...) white-noise variance for
    the first step. Returns (f_post, P_post)."""
    A, Gamma, C, Sigma = params
    eye = linalg.eye_like(P)
    fm = torch.as_tensor(first, device=P.device)[..., None, None]
    m = A @ f
    P_pred = torch.where(fm, P, A @ P @ _t(A) + Gamma)
    y_pred = torch.where(fm, torch.zeros_like(m), C @ m)
    nf = torch.as_tensor(noise_first, dtype=P.dtype, device=P.device)
    R = torch.where(fm, (nf / h)[..., None, None] * eye, Sigma / h)
    S = C @ P_pred @ _t(C) + R
    K = linalg.solve_spd_t(S, P_pred @ _t(C))
    f_post = m + K @ (y - y_pred)
    IKC = eye - K @ C
    P_post = IKC @ P_pred @ _t(IKC) + K @ R @ _t(K)
    return f_post, P_post


def rts_pair(f_prev, P_prev, f_cur, P_cur, A, Gamma):
    """One RTS step: condition (f_prev, P_prev) on (f_cur, P_cur)
    (GPI.backward_notrange, GPI.py:272-300)."""
    P_pred = A @ P_prev @ _t(A) + Gamma
    J = linalg.solve_spd_t(P_pred, P_prev @ _t(A))
    f_sm = f_prev + J @ (f_cur - A @ f_prev)
    P_sm = P_prev + J @ (P_cur - P_pred) @ _t(J)
    return f_sm, P_sm


def rts_smooth(A_seq, Gamma_seq, means, covs):
    """Full RTS backward pass with per-step parameters over the leading
    (time) axis: means (N, ..., T, 1), covs (N, ..., T, T); step t uses
    A_seq[t] (GPI.py:263-269)."""
    N = means.shape[0]
    f_out, P_out = [None] * N, [None] * N
    f_out[-1], P_out[-1] = means[-1], covs[-1]
    for t in range(N - 2, -1, -1):
        f_out[t], P_out[t] = rts_pair(means[t], covs[t], f_out[t + 1],
                                      P_out[t + 1], A_seq[t], Gamma_seq[t])
    return torch.stack(f_out), torch.stack(P_out)


# ---------------------------------------------------------------------------
# Associative-scan parallel filter / smoother (fixed parameters)
# ---------------------------------------------------------------------------


def _solve_nd(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """S^{-1} B for SPD S (..., T, T) and B (..., T, R) whose batch dims
    broadcast, as one ``spd_solve`` call (one kernel-B launch on a CUDA
    tensor)."""
    batch = torch.broadcast_shapes(S.shape[:-2], B.shape[:-2])
    T, R = S.shape[-1], B.shape[-1]
    S3 = S.expand(batch + (T, T)).reshape(-1, T, T).contiguous()
    B3 = B.expand(batch + (T, R)).reshape(-1, T, R).contiguous()
    return spd_solve(S3, B3).reshape(batch + (T, R))


def _shared_elements(F, Q, H, R, ys):
    """The non-first filtering elements (kalman.py:124-136) for the
    observations ys (N, ..., T, 1). With fixed (F, Q, H, R), A, C and J
    are the same for every observation and S = H Q H' + R is shared, so
    one ``spd_solve`` solves [(Q H')', H, y_1 .. y_N] at once. Returns
    A, C, J (..., T, T) and b, eta (N, ..., T, 1)."""
    T = F.shape[-1]
    S = H @ Q @ _t(H) + R
    QHt = Q @ _t(H)
    Ycols = torch.movedim(ys[..., 0], 0, -1)             # (..., T, N)
    batch = torch.broadcast_shapes(S.shape[:-2], Ycols.shape[:-2])
    X = _solve_nd(linalg.sym(S), torch.cat(
        [_t(QHt).expand(batch + (T, T)), H.expand(batch + (T, T)),
         Ycols.expand(batch + Ycols.shape[-2:])], dim=-1))
    K = _t(X[..., :T])                                   # Q H' S^{-1}
    IKH = linalg.eye_like(F) - K @ H
    A = IKH @ F
    C = IKH @ Q
    FtHt = _t(F) @ _t(H)
    J = FtHt @ X[..., T:2 * T] @ F
    b = torch.movedim(K @ Ycols, -1, 0)[..., None]
    eta = torch.movedim(FtHt @ X[..., 2 * T:], -1, 0)[..., None]
    return A, C, J, b, eta


def _filter_element(y, F, Q, H, R, m0=None, P0=None):
    """The associative filtering element (A, b, C, eta, J) of one
    observation y (..., T, 1) (kalman.py:111-136). With (m0, P0) it is
    the first element: an exact update from the prior."""
    if m0 is None:
        A, C, J, b, eta = _shared_elements(F, Q, H, R, y[None])
        return A, b[0], C, eta[0], J
    S = H @ P0 @ _t(H) + R
    K = _t(_solve_nd(linalg.sym(S), _t(P0 @ _t(H))))
    b = m0 + K @ (y - H @ m0)
    C = P0 - K @ S @ _t(K)
    zero = torch.zeros_like(C)
    return zero, b, C, torch.zeros_like(b), zero


def _combine(elem_l, elem_r):
    """Associative composition of two filtering elements
    (kalman.py:139-157)."""
    A1, b1, C1, eta1, J1 = elem_l
    A2, b2, C2, eta2, J2 = elem_r
    eye = linalg.eye_like(A1)
    # M = A2 (I + C1 J2)^{-1};  N = A1' (I + J2 C1)^{-1}
    I_C1J2 = eye + C1 @ J2
    I_J2C1 = eye + J2 @ C1
    # solve_ex: the LU solve without torch's host-side check of its
    # info (a device sync per call); like jnp.linalg.solve it returns
    # non-finite values for a singular system
    M = _t(torch.linalg.solve_ex(_t(I_C1J2), _t(A2))[0])
    Nt = torch.linalg.solve_ex(_t(I_J2C1), A1)[0]
    A = M @ A1
    b = M @ (b1 + C1 @ eta2) + b2
    C = M @ C1 @ _t(A2) + C2
    eta = _t(Nt) @ (eta2 - J2 @ b1) + eta1
    J = _t(Nt) @ J2 @ A1 + J1
    return A, b, C, eta, J


def parallel_filter(ys, F, Q, H, R, m0, P0):
    """Associative-scan Kalman filter with FIXED params
    (kalman.py:160-182). ys: (N, ..., T, 1). Returns the filtered means
    (N, ..., T, 1) and covariances (N, ..., T, T)."""
    first = _filter_element(ys[0], F, Q, H, R, m0=m0, P0=P0)
    A, C, J, b, eta = _shared_elements(F, Q, H, R, ys[1:])
    mat = b.shape[:-1] + (b.shape[-2],)                 # (N - 1, ..., T, T)
    rest = (A.expand(mat), b, C.expand(mat), eta, J.expand(mat))
    # the first element ahead of the rest, broadcast to their shape
    elems = tuple(torch.cat([f.expand(r.shape[1:])[None], r])
                  for f, r in zip(first, rest))
    _A, b, C, _eta, _J = associative_scan(_combine, elems)
    return b, C


def parallel_filter_masked(ys, h, F, Q, H, R, m0, P0):
    """Associative-scan Kalman filter with a per-step update mask
    (kalman.py:185-220). ys: (N, ..., T, 1); h: (N, ...) in {0, 1}. A
    step with h = 0 is the IDENTITY element (no prediction, no update);
    the prior (m0, P0) enters as a constant leading element. Returns the
    gated filtered means (N, ..., T, 1) and covariances (N, ..., T, T);
    element [-1] is the chunk carry.

    The elements are written straight into the scan's input buffers
    (one (N + 1, ..., T, T) tensor each for A, C and J), the largest
    allocation of the frozen-cluster classifier's chunk step."""
    A, C, J, b, eta = _shared_elements(F, Q, H, R, ys)
    N, T = ys.shape[0], ys.shape[-2]
    keep = (h > 0.5)[..., None, None]
    batch = torch.broadcast_shapes(keep.shape[1:-2], b.shape[1:-2])
    dt, dev = b.dtype, b.device
    eye = torch.eye(T, dtype=dt, device=dev)
    zero_m = torch.zeros((), dtype=dt, device=dev)
    prior = (torch.zeros((T, T), dtype=dt, device=dev), m0, P0,
             torch.zeros((T, 1), dtype=dt, device=dev),
             torch.zeros((T, T), dtype=dt, device=dev))
    elems = []
    for p, val, ident, w in zip(prior, (A, b, C, eta, J),
                                (eye, zero_m, zero_m, zero_m, zero_m),
                                (T, 1, T, 1, T)):
        buf = torch.empty((N + 1,) + batch + (T, w), dtype=dt, device=dev)
        buf[0] = p
        torch.where(keep, val, ident, out=buf[1:])
        elems.append(buf)
    _A, b, C, _eta, _J = associative_scan(_combine, tuple(elems))
    # drop the prior slot: position i is the state after step i
    return b[1:], C[1:]


def parallel_smooth(F, Q, means, covs):
    """Associative-scan RTS smoother with FIXED params
    (kalman.py:223-261). means/covs: filtered (N, ..., T, 1) /
    (N, ..., T, T). Returns the smoothed arrays."""
    f, P = means[:-1], covs[:-1]
    P_pred = F @ P @ _t(F) + Q
    E = _t(_solve_nd(linalg.sym(P_pred), _t(P @ _t(F))))
    g = f - E @ F @ f
    L = P - E @ P_pred @ _t(E)
    E = torch.cat([E, torch.zeros_like(covs[-1:])])
    g = torch.cat([g, means[-1:]])
    L = torch.cat([L, covs[-1:]])

    def combine_rev(a, b):
        # reverse=True: ``a`` is the already-combined LATER suffix, ``b``
        # the EARLIER element; b's affine map is applied to a
        E_a, g_a, L_a = a
        E_b, g_b, L_b = b
        return (E_b @ E_a, E_b @ g_a + g_b, E_b @ L_a @ _t(E_b) + L_b)

    _Es, gs, Ls = associative_scan(combine_rev, (E, g, L), reverse=True)
    return gs, Ls
