"""Multi-record scale-out (counterpart of hdpgpc_tpu.parallel.records).

Each record's (patient's) VI state is independent, so a 48-record
MIT-BIH sweep is data parallel over records with no cross-record work
but the ELBO's sum. ``build_sharded_vi_step`` builds one
fixed-assignment VI iteration over R records of K clusters each: the
refit of every (record, cluster) pair, the HMM forward-backward and the
ELBO pieces, optionally with the HDP theta update on the device.

Where hdpgpc_tpu vmaps the one-cluster refit over K inside a vmap over
R, this port runs ONE batched ``gplds.build_refit`` call over the
J = R K (record, cluster) jobs, so each forward step of the refit
launches kernel B once at (4 J, T, T); everything after the refit is
batched over R (``ops.hmm.fb_hard`` takes leading record dims), with no
loop over records. The refit holds no reduction across jobs, so a
record's result does not depend on the others. Records are taken in
groups sized from the device's free memory (``record_group_size``); on
the CPU the grouping changes no bit (tests/test_torch_records.py).

Across several devices, the counterpart of the mesh's ``P("records")``
sharding is a ``torch.distributed`` process group: each rank takes a
contiguous block of the records (``shard_records``) and the ELBO is
all-reduced (the mesh's replicated ``P()`` output). NCCL on cards, gloo
on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from hdpgpc_torch.device import DEFAULT_DEVICE, resolve_device
from hdpgpc_torch.models import gplds
from hdpgpc_torch.models.gplds import ClusterState
from hdpgpc_torch.models.streaming import free_memory
from hdpgpc_torch.ops import hmm as hmm_ops
from hdpgpc_torch.ops.kernels import KernelParams

# The batched refit of one record holds, at its peak, REFIT_LIVE_TT
# (T, T) matrices per cluster and member slot: what the forward and
# backward passes keep (the filtered and smoothed covariances and the
# per-slot A, Gamma, Sigma: 5; past an estimation limit E also the
# sequential head's and the parallel tail's pieces beside their
# concatenations, ~3.3 at E = 1000, N = 2272), the scoring's factors
# of the distinct slots (the symmetrised Sigmas and their factors,
# Gamma, A, Gamma's factors and Gamma^-1 A: six stacks of
# min(N, E + 1) slots) and a factorisation's temporaries. The scoring
# gathers per chunk of gplds.SCORE_CHUNK beats or slots, whatever N.
# Without a bucket every beat is a slot of every cluster, so a record
# needs REFIT_LIVE_TT K N T^2 elements (at K = 4, N = 2272, T = 90 in
# float32: 4.1 GB); a group of records is sized to fill
# GROUP_MEMORY_FRACTION of the free memory with them. Measured on an
# H100 (chip_smoke.py records phase): 11.98 at est_limit 1000, 13.11
# at est_limit None (16.2 at both before the scoring was chunked).
REFIT_LIVE_TT = 14
GROUP_MEMORY_FRACTION = 0.8


def record_group_size(K: int, N: int, T: int, dtype: torch.dtype,
                      free_bytes: int) -> int:
    """Records per batched refit call: the most whose refit fits in
    GROUP_MEMORY_FRACTION of ``free_bytes``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_record = REFIT_LIVE_TT * K * N * T * T * itemsize
    return max(1, int(GROUP_MEMORY_FRACTION * free_bytes) // per_record)


# ---------------------------------------------------------------------
# the process group over which records are split
# ---------------------------------------------------------------------

def _rank_world(group) -> tuple:
    if group is None:
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def make_mesh(n_devices: Optional[int] = None, group=None) -> list:
    """The ranks that hold records: those of ``group`` (a
    ``torch.distributed`` process group; None is this one process), the
    first ``n_devices`` of them."""
    ranks = list(range(_rank_world(group)[1]))
    return ranks if n_devices is None else ranks[:n_devices]


def record_slice(R: int, rank: int, world: int) -> slice:
    """The contiguous block of R records that ``rank`` of ``world`` takes
    (the first R % world ranks take one more)."""
    base, extra = divmod(R, world)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (1 if rank < extra else 0))


def shard_records(x, group=None):
    """This rank's block of the records: ``x`` a tensor or array with the
    records on dim 0, or a ``ClusterState`` with (R, K) leading dims."""
    rank, world = _rank_world(group)
    if isinstance(x, tuple):
        return gplds.tree_map(lambda a: shard_records(a, group), x)
    return x[record_slice(x.shape[0], rank, world)]


# ---------------------------------------------------------------------
# the HDP theta update on the device, batched over records
# ---------------------------------------------------------------------

def rho_to_beta_device(rho: torch.Tensor) -> torch.Tensor:
    """E[beta] with the leftover stick appended (stick_breaking
    rho_to_beta, 'K+1' form); rho (*B, K) -> (*B, K + 1)."""
    one = torch.ones(rho.shape[:-1] + (1,), dtype=rho.dtype,
                     device=rho.device)
    one_minus = torch.cat([one, torch.cumprod(1.0 - rho, dim=-1)], -1)
    return torch.cat([rho, one], -1) * one_minus


def theta_from_counts_device(rho, trans_counts, start_counts,
                             trans_alpha, start_alpha, kappa):
    """Device-side _calcThetaFull (GPI_HDP.py:400-422) at M = K + 1:
    posterior Dirichlet parameters from transition counts (*B, K, K) and
    start counts (*B, K)."""
    K = rho.shape[-1]
    M = K + 1
    Ebeta = rho_to_beta_device(rho)                       # (*B, M)
    tt = (trans_alpha * Ebeta)[..., None, :].expand(
        rho.shape[:-1] + (M, M))
    pad_tc = rho.new_zeros(rho.shape[:-1] + (M, M))
    pad_tc[..., :K, :K] = trans_counts
    pad_eye = rho.new_zeros((M, M))
    pad_eye[:K, :K] = kappa * torch.eye(K, dtype=rho.dtype,
                                        device=rho.device)
    tt = tt + pad_tc + pad_eye
    st = start_alpha * Ebeta
    st = torch.cat([st[..., :K] + start_counts, st[..., K:]], -1)
    return tt, st


def log_pis_from_theta_device(trans_theta, start_theta, K: int):
    """E[log pi] via digamma with the digamma-of-row-sum denominator
    (compute_trans_A, GPI_HDP.py:3527-3535)."""
    dg = torch.special.digamma
    den_t = dg(torch.sum(trans_theta[..., :K, :K + 1], dim=-1))
    trans_log_pi = dg(trans_theta[..., :K, :K]) - den_t[..., None]
    den_s = dg(torch.sum(start_theta[..., :K + 1], dim=-1))
    start_log_pi = dg(start_theta[..., :K]) - den_s[..., None]
    return trans_log_pi, start_log_pi


# ---------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------

def _as(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(dtype)


def _state_to(states: ClusterState, dtype, dev) -> ClusterState:
    """Floating leaves in the compute dtype on ``dev`` (the counts stay
    int32; reinit_cluster_state resets the MNIW dof to float64)."""
    return gplds.tree_map(
        lambda x: x.to(dev) if not x.is_floating_point()
        else x.to(device=dev, dtype=dtype), states)


def build_sharded_vi_step(T: int, K: int, est_limit=None,
                          annealing: bool = True, hdp_update: bool = False,
                          trans_alpha: float = 1.0,
                          start_alpha: float = 0.1, kappa: float = 0.0,
                          device=DEFAULT_DEVICE, group=None,
                          records_per_group: Optional[int] = None):
    """Build one multi-record VI iteration.

    Inputs (per call; numpy or tensors, moved to ``device``; the compute
    dtype is Y's):
      Y:     (R, N, T)   beats
      resp:  (R, N, K)   hard responsibilities
      states: ClusterState with leading (R, K) dims
      start_log_pi: (R, K), trans_log_pi: (R, K, K)
        (with ``hdp_update=True`` these are instead rho (R, K), the
        stick-breaking point estimates, and the previous respPair
        (R, N, K, K): the transition structure is recomputed on the
        device from counts by the HDP theta update, GPI_HDP.py:890-908)

    Returns (q (R, N, K), q_lat, resp', respPair', elbo (0-d: the sum
    over records), states'). With ``group`` (a torch.distributed process
    group) each rank passes its own block of records (``shard_records``)
    and gets that block's outputs; the ELBO is all-reduced over the
    group. ``records_per_group`` caps the records of one batched refit
    (default: sized from the free memory of ``device``).

    Births and the rho/omega L-BFGS refinement are host-side, per
    record, between step calls, as in hdpgpc_tpu.
    """
    dev = resolve_device(device)
    refit = gplds.build_refit(T, est_limit=est_limit, annealing=annealing)

    def run_group(Y, resp, states, start_r, trans_r):
        G, N, _ = Y.shape
        # contiguous jobs: a broadcast (stride 0) input would let a
        # reduction or a solve take another order at another G, and a
        # record's bits would then depend on its group
        flat = gplds.tree_map(
            lambda x: x.reshape((G * K,) + tuple(x.shape[2:])).contiguous(),
            states)
        st = gplds.reinit_cluster_state(flat, free_deg=5.0)
        Yj = Y[:, None].expand(G, K, N, T).reshape(G * K, N, T).contiguous()
        Rj = resp.permute(0, 2, 1).reshape(G * K, N).contiguous()
        res = refit(Yj, Rj, st)
        # (G K, N) -> (G, K, N) -> (G, N, K): the per-record q.T
        q = res.q.reshape(G, K, N).permute(0, 2, 1)
        q_lat = res.q_lat.reshape(G, K, N).permute(0, 2, 1)
        states2 = gplds.tree_map(
            lambda x: x.reshape((G, K) + tuple(x.shape[1:])), res.state)
        if hdp_update:
            tt, st_theta = theta_from_counts_device(
                start_r, torch.sum(trans_r, dim=1), resp[:, 0],
                trans_alpha, start_alpha, kappa)
            trans_lp, start_lp = log_pis_from_theta_device(tt, st_theta, K)
        else:
            start_lp, trans_lp = start_r, trans_r
        resp2, _lr, respPair2, _lrp = hmm_ops.fb_hard(start_lp, trans_lp, q)
        elbo_r = (torch.sum(q * resp2, dim=(-2, -1))
                  + torch.sum(q_lat * resp2, dim=(-2, -1))
                  + hmm_ops.entropy_terms(resp2, respPair2))
        return q, q_lat, resp2, respPair2, elbo_r, states2

    def step(Y, resp, states, start_log_pi, trans_log_pi):
        Y = torch.as_tensor(Y, device=dev)
        dt = Y.dtype
        resp = _as(resp, dt, dev)
        start_log_pi = _as(start_log_pi, dt, dev)
        trans_log_pi = _as(trans_log_pi, dt, dev)
        states = _state_to(states, dt, dev)
        R, N, _ = Y.shape
        G = records_per_group or record_group_size(K, N, T, dt,
                                                   free_memory(dev))
        outs = [run_group(Y[s:s + G], resp[s:s + G],
                          gplds.tree_map(lambda x: x[s:s + G], states),
                          start_log_pi[s:s + G], trans_log_pi[s:s + G])
                for s in range(0, R, max(1, G))]
        q, q_lat, resp2, respPair2, elbo_r = (
            torch.cat([o[i] for o in outs]) for i in range(5))
        states2 = gplds.tree_map(lambda *xs: torch.cat(xs),
                                 *[o[5] for o in outs])
        elbo = torch.sum(elbo_r)
        if group is not None:
            import torch.distributed as dist
            dist.all_reduce(elbo, group=group)
        step.last_groups = len(outs)
        step.last_group_size = G
        return q, q_lat, resp2, respPair2, elbo, states2

    step.last_groups = 0
    step.last_group_size = 0
    return step


def _state_proto(T: int, theta: Optional[KernelParams] = None,
                 ini_gamma: float = 0.01, ini_sigma: float = 0.25,
                 device=DEFAULT_DEVICE, dtype=torch.float64) -> ClusterState:
    """One fresh cluster on the grid [0, T) (float64, as hdpgpc_tpu's),
    its state in ``dtype``: kernel A builds its prior Gram on a card."""
    if theta is None:
        theta = KernelParams(1.0, 3.0, 0.1)
    xb = torch.arange(T, dtype=torch.float64, device=resolve_device(device))
    return gplds.init_cluster_state(xb, theta, ini_gamma, ini_sigma, 5.0,
                                    dtype=dtype)


def init_record_states(R: int, K: int, T: int,
                       theta: Optional[KernelParams] = None,
                       ini_gamma: float = 0.01, ini_sigma: float = 0.25,
                       device=DEFAULT_DEVICE,
                       dtype=torch.float64) -> ClusterState:
    """(R, K)-batched fresh cluster states (broadcast views of one)."""
    if theta is None:
        theta = KernelParams(1.0, 3.0, ini_sigma)
    st = _state_proto(T, theta, ini_gamma, ini_sigma, device, dtype)
    return gplds.tree_map(
        lambda x: x.expand((R, K) + tuple(x.shape)), st)


def sharded_vi_step(Y, resp, states, start_log_pi, trans_log_pi,
                    device=DEFAULT_DEVICE, group=None):
    """Convenience wrapper building and running one step."""
    R, N, T = Y.shape
    K = resp.shape[2]
    step = build_sharded_vi_step(T, K, device=device, group=group)
    return step(Y, resp, states, start_log_pi, trans_log_pi)
