"""The refit's scoring in chunks of SCORE_CHUNK = 256 beats and slots
(models/gplds.py build_refit, as hdpgpc_tpu's lax.map over CHUNK and
LCH): at T = 24, J = 2 jobs of N = 600 beats (two full chunks and a
ragged one), float64,

* q, q_lat and snr against hdpgpc_tpu's build_refit, job by job, to
  <= 1e-9 relative, at est_limit None and 50 (the hybrid tail);
* each job of a J = 3 batch bit for bit against the job with no other
  job's data (a batch of two copies of it), and to 1e-12 against the
  one-job call;
* no gather of (T, T) matrices wider than a chunk (the emission factors
  and the latent scoring's covariances, A and factors were gathered
  (J, N, T, T) at once before).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hdpgpc_torch import convert
from hdpgpc_torch.models import gplds as tg
from hdpgpc_tpu.models import gplds as jg
from hdpgpc_tpu.ops.kernels import KernelParams as JKP

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, N = 24, 600


def _state():
    th = JKP(jnp.asarray(1.5), jnp.asarray(2.0), jnp.asarray(0.05))
    return jg.init_cluster_state(jnp.arange(T, dtype=jnp.float64), th,
                                 0.02, 0.1, 5.0, dtype=jnp.float64)


def _jobs(J):
    """J jobs: beats around a sine; job 0 a member in ~70% of the beats,
    job 1 in the first 300 only, job 2 in every fifth."""
    Ys, Rs = [], []
    for j in range(J):
        rng = np.random.default_rng(j)
        Ys.append(np.sin(np.linspace(0, 2 * np.pi, T) + 0.3 * j)[None]
                  + 0.1 * rng.standard_normal((N, T)))
        if j == 0:
            r = (rng.uniform(size=N) < 0.7).astype(np.float64)
        elif j == 1:
            r = (np.arange(N) < 300).astype(np.float64)
        else:
            r = (np.arange(N) % 5 == 0).astype(np.float64)
        Rs.append(r)
    return np.stack(Ys), np.stack(Rs)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("est_limit", [None, 50])
def test_chunked_scores_match_jax(est_limit):
    Y, R = _jobs(2)
    st_j = _state()
    st_t = convert.cluster_state_from_numpy(jax.device_get(st_j))
    rt = tg.build_refit(T, est_limit=est_limit, free_deg=5.0)(
        torch.as_tensor(Y), torch.as_tensor(R), tg.stack_states([st_t] * 2))
    ref = jg.build_refit(T, est_limit=est_limit, free_deg=5.0)
    for j in range(2):
        rj = ref(jnp.asarray(Y[j]), jnp.asarray(R[j]), st_j)
        for f in ("q", "q_lat", "snr"):
            a = getattr(rt, f)[j].numpy()
            assert a.shape == (N,)
            assert _rel(a, getattr(rj, f)) <= 1e-9, (j, f)
        assert np.any(np.asarray(rj.q_lat) != 0.0)


@pytest.mark.parametrize("est_limit", [None, 50])
def test_batch_equals_each_job_alone_bit_for_bit(est_limit):
    """Job j of the batch [0, 1, 2] against job j with no other job's
    data: bit for bit against a batch of two copies of it, and to 1e-12
    against the one-job call. (At one job, torch's CPU bmm takes its
    matrix-vector path for the forward pass's (T, T) x (T, 1) products,
    whose sums round otherwise than inside a batch of two or more:
    bmm((1, 24, 24), (1, 24, 1)) differs in the last bit from the same
    product in a batch of 3; batches of 2 and 3 agree.)"""
    Y, R = _jobs(3)
    st = convert.cluster_state_from_numpy(jax.device_get(_state()))
    refit = tg.build_refit(T, est_limit=est_limit, free_deg=5.0)
    rb = refit(torch.as_tensor(Y), torch.as_tensor(R),
               tg.stack_states([st] * 3))
    for j in range(3):
        r2 = refit(torch.as_tensor(Y[[j, j]]), torch.as_tensor(R[[j, j]]),
                   tg.stack_states([st] * 2))
        r1 = refit(torch.as_tensor(Y[j]), torch.as_tensor(R[j]), st)
        for f in ("q", "q_lat", "snr"):
            assert torch.equal(getattr(rb, f)[j], getattr(r2, f)[0]), (j, f)
            assert _rel(getattr(r1, f), getattr(rb, f)[j]) <= 1e-12, (j, f)
        for a, b in zip(convert.tree_leaves(tg.index_state(rb.state, j)),
                        convert.tree_leaves(tg.index_state(r2.state, 0))):
            assert torch.equal(a, b), j


class _Gathers(TorchDispatchMode):
    """The widths (dim 1) of every (J, S, T, T) output of an indexing
    gather."""

    def __init__(self):
        super().__init__()
        self.widths = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.index.Tensor,
                    torch.ops.aten.index_select.default) \
                and out.ndim == 4 and tuple(out.shape[-2:]) == (T, T):
            self.widths.append(out.shape[1])
        return out


@pytest.mark.parametrize("est_limit", [None, 50])
def test_no_gather_wider_than_a_chunk(est_limit):
    Y, R = _jobs(2)
    st = convert.cluster_state_from_numpy(jax.device_get(_state()))
    refit = tg.build_refit(T, est_limit=est_limit, free_deg=5.0)
    mode = _Gathers()
    with mode:
        refit(torch.as_tensor(Y), torch.as_tensor(R),
              tg.stack_states([st] * 2))
    # emission factors (3 chunks), and the latent scoring's previous
    # covariances, two factor stacks and A (3 chunks each)
    assert len(mode.widths) >= 12
    assert max(mode.widths) <= tg.SCORE_CHUNK
    assert N % tg.SCORE_CHUNK in mode.widths
