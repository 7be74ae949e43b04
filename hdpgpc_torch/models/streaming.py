"""Frozen-cluster streaming classifier (counterpart of
hdpgpc_tpu.models.streaming; the fixed-K 1M-beat stress configuration,
BASELINE config 5, docs/STRESS.md).

Past the estimation limit every cluster is a FIXED linear-Gaussian
system, so the per-beat work parallelises over the beat axis. Beats
stream in chunks; each chunk

1. scores every beat against every cluster: one kernel-B launch solves
   the K jittered observation covariances (K, T, T) against the chunk's
   residuals (K, T, B); the score is -0.5 d' Sigma^-1 d - 0.5 T log 2pi
   (no log-det, the reference's scoring);
2. runs the HMM forward pass over the chunk, a loop of small device ops
   that reads nothing back to the host (the labels stay on the device
   until the stream ends);
3. updates each cluster's posterior over its assigned beats with the
   gated associative-scan filter (ops/kalman.parallel_filter_masked),
   the K clusters as one batch: one kernel-B launch solves every
   cluster's shared S against [(Q H')', H, the chunk's beats].

The carry between chunks is O(K T^2), whatever the stream's length. The
scan's (K, B, T, T) elements set the peak memory, so ``stream_classify``
sizes the chunk from the free device memory (``stream_chunk``).
Unlike hdpgpc_tpu (streaming.py:155), the mask and the counts stay in
the state's dtype.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hdpgpc_torch.device import DEFAULT_DEVICE, resolve_device
from hdpgpc_torch.ops import linalg
from hdpgpc_torch.ops.kalman import parallel_filter_masked
from hdpgpc_torch.ops.spd_solve import spd_solve

# (T, T) matrices live per (cluster, beat) of a chunk at the step's
# peak: the scan's A, C, J inputs (3), its first level's combine
# temporaries and outputs (6), the recursion's odd half and the
# interleaved output (see ops/scan.py); 9.15 measured on an H100 at
# K = 64, T = 90, float32, chunk 2019
LIVE_TT_PER_BEAT = 12
# the share of the free memory a chunk may take
CHUNK_MEMORY_FRACTION = 0.6


class StreamState(NamedTuple):
    """Frozen-parameter streaming state for K clusters."""

    f: torch.Tensor            # (K, T, 1) cluster posterior means
    P: torch.Tensor            # (K, T, T) posterior covariances
    A: torch.Tensor            # (K, T, T) frozen LDS params
    Gamma: torch.Tensor
    C: torch.Tensor
    Sigma: torch.Tensor
    counts: torch.Tensor       # (K,) assigned-beat counts
    fmsg: torch.Tensor         # (K,) HMM forward message (normalised)
    trans_log_pi: torch.Tensor  # (K, K)


def init_stream_state(templates, ini_gamma: float, ini_sigma: float,
                      trans_log_pi=None, device=None) -> StreamState:
    """templates: (K, T) initial cluster means (e.g. from an offline
    warm-up segment). The state lives on ``device``: by default the
    templates' device when they are a tensor, else the card."""
    if device is None:
        device = templates.device if isinstance(templates, torch.Tensor) \
            else DEFAULT_DEVICE
    dev = resolve_device(device)
    tm = torch.as_tensor(templates, device=dev)
    K, T = tm.shape
    dt = tm.dtype
    eye = torch.eye(T, dtype=dt, device=dev).expand(K, T, T)
    if trans_log_pi is None:
        trans_log_pi = torch.log(torch.full((K, K), 1.0 / K, dtype=dt,
                                            device=dev))
    return StreamState(
        f=tm[..., None].clone(), P=(ini_sigma * eye).contiguous(),
        A=eye.contiguous(), Gamma=(ini_gamma * eye).contiguous(),
        C=eye.contiguous(), Sigma=(ini_sigma * eye).contiguous(),
        counts=torch.zeros(K, dtype=dt, device=dev),
        fmsg=torch.full((K,), 1.0 / K, dtype=dt, device=dev),
        trans_log_pi=torch.as_tensor(trans_log_pi, dtype=dt, device=dev))


def emission_scores(Y: torch.Tensor, means: torch.Tensor,
                    Sigma: torch.Tensor) -> torch.Tensor:
    """q (B, K): each beat of Y (B, T) against each of K Gaussians
    (means (K, T), covariances Sigma (K, T, T)), -0.5 d' Sigma^-1 d -
    0.5 T log 2pi with ``chol_spd``'s jitter and no log-det (the
    reference's gaussian_score_shared_cov, one cluster at a time): the
    K systems against the B residuals in one ``spd_solve`` launch."""
    D = (Y[None] - means[:, None]).transpose(1, 2).contiguous()  # (K, T, B)
    X = spd_solve(linalg.spd_jitter(Sigma), D)
    return (-0.5 * torch.sum(D * X, dim=1)
            - 0.5 * Y.shape[1] * linalg.LOG2PI).T


def build_stream_step(T: int, K: int):
    """One chunk step: (state, Y (B, T), mask (B,)) -> (state', labels
    (B,) on the state's device)."""

    def step(state: StreamState, Y: torch.Tensor, mask: torch.Tensor
             ) -> Tuple[StreamState, torch.Tensor]:
        """mask: 1.0 for real beats, 0.0 for padding (padding neither
        advances the HMM message nor updates any cluster)."""
        B = Y.shape[0]
        logq = emission_scores(Y, (state.C @ state.f)[..., 0],
                               state.Sigma)                   # (B, K)

        # --- streaming HMM forward pass over the chunk ---
        tlp = state.trans_log_pi
        PiT = torch.exp(tlp - tlp.max(dim=1, keepdim=True).values).T
        PiT = torch.where(PiT < 1e-6, PiT + 1e-4, PiT).contiguous()
        ev = torch.exp(logq - logq.max(dim=1, keepdim=True).values)
        keep = mask > 0.5
        fm = state.fmsg
        fms = []
        for t in range(B):
            fm2 = (PiT @ fm) * ev[t]
            fm2 = fm2 / torch.sum(fm2)
            fm = torch.where(keep[t], fm2, fm)
            fms.append(fm)
        labels = torch.argmax(torch.stack(fms), dim=1)        # (B,)

        # --- per-cluster posterior update over assigned beats ---
        onehot = torch.nn.functional.one_hot(labels, K).to(Y.dtype) \
            * mask[:, None]
        fs, Ps = parallel_filter_masked(
            Y[:, None, :, None], onehot, state.A, state.Gamma, state.C,
            state.Sigma, state.f, state.P)
        # clone: the carry must not hold the scan's (B, K, T, T) buffers
        return state._replace(f=fs[-1].clone(), P=Ps[-1].clone(),
                              counts=state.counts + onehot.sum(dim=0),
                              fmsg=fm), labels

    return step


def stream_chunk(K: int, T: int, dtype: torch.dtype, free_bytes: int
                 ) -> int:
    """The largest chunk whose step fits in CHUNK_MEMORY_FRACTION of
    ``free_bytes``: LIVE_TT_PER_BEAT (T, T) matrices per cluster and
    beat."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_beat = LIVE_TT_PER_BEAT * K * T * T * itemsize
    return max(1, int(CHUNK_MEMORY_FRACTION * free_bytes) // per_beat)


def free_memory(device: torch.device) -> int:
    """Bytes a chunk step may allocate on ``device``: the card's free
    memory plus what PyTorch's allocator holds unused; on the CPU the
    available physical memory."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free + (torch.cuda.memory_reserved(device)
                       - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def stream_classify(state: StreamState, Y, chunk: Optional[int] = None):
    """Stream a long beat tensor through chunked steps.

    Y: (N, T) (numpy or a tensor). Returns (state, labels (N,) numpy
    int64). N is processed in chunks of ``chunk`` beats (by default
    sized from the free memory of the state's device, at most N); the
    last chunk is padded with its last beat and masked."""
    K, T = state.f.shape[0], state.f.shape[1]
    dev, dt = state.f.device, state.f.dtype
    # compute in the state's dtype, as hdpgpc_tpu does
    Yd = torch.as_tensor(Y, device=dev).to(dt)
    N = Yd.shape[0]
    if chunk is None:
        chunk = min(N, stream_chunk(K, T, dt, free_memory(dev)))
    step = build_stream_step(T, K)
    labels = []
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        block = Yd[s:e]
        if e - s < chunk:
            block = torch.cat([block, block[-1:].expand(chunk - (e - s), T)])
        mask = torch.zeros(chunk, dtype=dt, device=dev)
        mask[: e - s] = 1.0
        state, lab = step(state, block, mask)
        labels.append(lab[: e - s])
    out = torch.cat(labels).cpu().numpy().astype(np.int64) if labels \
        else np.empty(0, np.int64)
    return state, out
