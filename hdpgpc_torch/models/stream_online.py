"""Fused online streaming VI engine (counterpart of
hdpgpc_tpu.models.stream_online).

The cached online step (GPI_HDP.include_sample_fast,
GPI_HDP.py:2312-2629; the host-orchestrated
``HDPGPC.include_sample_fast``) makes one host-driven decision per
beat. This engine keeps the whole per-beat decision on the device:
scoring, the birth and absorb candidates, the one-sample ELBO
accounting (masked elbo_Linears, ops/sb_device.py), the commit, the
popularity reorder and the deterministic part of the HDP global update,
on a preallocated bank of K cluster slots (a birth takes the next free
slot, so every shape is fixed). The host refines rho/omega (the scipy
L-BFGS-B step the reference runs per beat, OptimizerRhoOmega.py) at
chunk boundaries and collects the per-beat assignments at the end.

One beat is one call of the step function on device tensors; a chunk is
a Python loop over its beats. The K absorb candidates of a beat go
through ONE batched ``make_forward_step``, so kernel B solves one
(4K, T, T) stack for them; the birth candidate adds a (2, T, T) stack
and the commit a (4, T, T) one. A first member's kernel fit is a host
branch (one device read per beat, ``need_fit``), and its Gram is written
by kernel A (``gplds.apply_kernel_fit``); the step counts its fits and
their seconds, synchronised on the card (``step.fits``,
``step.fit_seconds``).

The beat is written once, as a generator (``beat``) that yields at its
four host actions: the three kernel B calls and the ``need_fit`` read.
A CPU tensor's beat drives it eagerly, op by op. On a CUDA device the
first beat of a (K, T, dtype, device) runs eagerly on a side stream,
the second captures the five stretches between the host actions as
CUDA graphs on that stream (``BeatGraphs``), and every later beat
replays them: the carry and the beat are copied into the graphs'
static buffers, the graphs replay in order with the three kernel B
calls launched eagerly between them (through ``gplds.spd_solve``,
looked up at every call), the ``need_fit`` read and, on a first
member, the kernel fit between the third graph and the fourth, and the
new carry and the StepOut come out as fresh clones. So the step never
writes a tensor it was given or has returned, and its arithmetic is
the eager beat's. A failed capture raises.

While the recorder of utils/metrics is on, each beat is a
``stream.step`` span and counts as ``stream.eager_beats`` or
``stream.graph_beats``. An eager beat's span holds its sections
(``step.score``, ``step.candidates``, ``step.elbo``, ``step.decide``,
``step.commit`` with the ``need_fit`` read ``step.fit_read`` and a
first member's ``step.kernel_fit`` inside it, ``step.reorder``); a
replayed beat's holds ``step.copy_in``, ``step.seg[i]`` (the i-th
graph's replay, i = 1..5), ``step.fit_read``, ``step.kernel_fit`` and
``step.copy_out``. Each refresh is a ``stream.refresh`` span and the
read of a run's assignments ``stream.collect``. The spans read the
host's clock, so a section's span covers the launching of its work,
and ``step.fit_read`` the host's wait for the beat's queued work.

With chunk=1 the rho/omega cadence is the reference's (refined between
every two beats); larger chunks amortise the L-BFGS over many beats
(rho/omega are reinitialised deterministically on the device every
beat, as the reference does, but the refinement lags by up to chunk
beats).

Scope: one lead, warp off, bayesian dynamics, hmm_switch=True. Other
configurations use HDPGPC.include_sample_fast.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from hdpgpc_torch.models import gplds
from hdpgpc_torch.models.gplds import (ClusterState, make_forward_step,
                                       tree_leaves, tree_map)
from hdpgpc_torch.models.kernel_fit import _adam_fit
from hdpgpc_torch.ops import sb_device as sbd
from hdpgpc_torch.ops import stick_breaking as sb
from hdpgpc_torch.ops.kernels import KernelParams
from hdpgpc_torch.utils.metrics import count, span

HDT = torch.float64   # accounting dtype (counts, ELBO terms, sums)


class StreamState(NamedTuple):
    """Device-resident carry of the engine (all fixed shapes; K = cluster
    slots)."""

    states: ClusterState     # stacked (K, ...)
    fitted: torch.Tensor     # (K,) bool: kernel hyperparameters fitted
    n: torch.Tensor          # (K,) int32 member counts
    last_t: torch.Tensor     # (K,) int32 time of the last member (-1)
    qlat_last: torch.Tensor  # (K,) cached q_lat value at the last member
    lds: torch.Tensor        # (K,) memoised lds_param_elbo per cluster
    q_sel_sum: torch.Tensor  # sum of the selected q cache entries
    qlat_sel_sum: torch.Tensor  # sum of the selected q_lat entries
    prev_state: torch.Tensor  # int32 slot assigned at beat t-1
    start_counts: torch.Tensor  # (K+1,)
    trans_counts: torch.Tensor  # (K+1, K+1)
    rho: torch.Tensor        # (K,)
    omega: torch.Tensor      # (K,)
    M_rho: torch.Tensor      # int32 live rho size
    M: torch.Tensor          # int32 live clusters
    t: torch.Tensor          # int32 beats processed
    slot_uid: torch.Tensor   # (K,) int32 stable cluster identity
    uid_next: torch.Tensor   # int32


class StepOut(NamedTuple):
    uid: torch.Tensor        # stable id of the chosen cluster
    slot: torch.Tensor       # slot index after the reorder
    birth: torch.Tensor      # bool
    M: torch.Tensor          # live clusters after the step


def _take(tree, idx: torch.Tensor):
    """Gather the slots ``idx`` (1-D) of every leaf (no host read)."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a device scalar index ``i`` without the host read
    that indexing with a 0-dim tensor makes (it reads the index as a
    Python int)."""
    return x.index_select(0, i.reshape(1))[0]


def _append_state(st: ClusterState, y, fwd):
    """Append ONE beat to a (J-stacked) cluster state with the shared
    refit step (make_forward_step) and the single-member compact-summary
    update (gplds.build_refit's summary rules for mb == 1,
    full_backward=False). A generator: it yields the step's kernel B
    operands ``("solve", spd, rhs)``, takes their solution back and
    returns the new state."""
    J = st.n.shape[0]
    mniw0 = tree_map(lambda a, b: torch.stack([a, b], 1), st.mniw_int,
                     st.mniw_obs)
    G0diag = torch.diagonal(st.Gamma_def, dim1=-2, dim2=-1).mean(-1)
    S0diag = torch.diagonal(st.Sigma_def, dim1=-2, dim2=-1).mean(-1)
    carry0 = (st.f_last, st.P_last, st.f_prev, st.P_prev,
              st.A, st.Gamma, st.C, st.Sigma, mniw0, st.n,
              st.theta.noise, G0diag, S0diag)
    one = torch.ones(J, dtype=st.A.dtype, device=st.A.device)
    ctx, spd, rhs = fwd.prepare(carry0, (y.expand(J, -1), one))
    X = yield "solve", spd, rhs
    new_carry, emit = fwd.finish(ctx, X)
    (_member, f_n, P_n, _A, _G, _S, _sm, f_smp, P_smp) = emit
    (_f, _P, f_prevF, P_prevF, A_f, G_f, C_f, S_f,
     mniw_f, n_f, *_aux) = new_carry
    w = gplds._w
    n_before = st.n
    has2 = n_f > 1
    first0, first1 = n_before == 0, n_before == 1
    return st._replace(
        n=n_f,
        f_last=f_n, P_last=P_n,
        f_prev=w(has2, f_prevF, st.f_prev),
        P_prev=w(has2, P_prevF, st.P_prev),
        f_sm_last=f_n, P_sm_last=P_n,
        f_sm_prev=w(n_before >= 1, f_smp, st.f_sm_prev),
        P_sm_prev=w(n_before >= 1, P_smp, st.P_sm_prev),
        f_sm_prev2=st.f_sm_prev, P_sm_prev2=st.P_sm_prev,
        f_sm_first=w(first0, f_n, w(first1, f_smp, st.f_sm_first)),
        P_sm_first=w(first0, P_n, w(first1, P_smp, st.P_sm_first)),
        A=A_f, Gamma=G_f, C=C_f, Sigma=S_f,
        A_prev=st.A, Gamma_prev=st.Gamma,
        mniw_int=tree_map(lambda a: a[:, 0], mniw_f),
        mniw_obs=tree_map(lambda a: a[:, 1], mniw_f),
    )


def _unflatten(proto, leaves):
    """A tree shaped like ``proto`` from an iterator of its leaves."""
    if isinstance(proto, tuple):
        items = [_unflatten(p, leaves) for p in proto]
        return type(proto)(*items) if hasattr(proto, "_fields") \
            else tuple(items)
    return next(leaves)


class Packing:
    """A tree's layout as one flat buffer per dtype: each leaf is a view
    of its dtype's buffer, at a fixed offset, in leaf order.

    ``pack`` gathers a tree of this layout into fresh buffers (one
    ``cat`` a dtype), ``unpack`` views buffers as the tree, and
    ``copy_into`` copies a tree into buffers, one copy a dtype where
    that dtype's leaves are the views ``unpack`` made of one buffer of
    this layout or a longer one whose head it is, else leaf by leaf."""

    def __init__(self, tree):
        leaves = tree_leaves(tree)
        self.proto = _unflatten(tree, iter([None] * len(leaves)))
        self.slots = []                   # (dtype, offset, shape) a leaf
        self.sizes = {}                   # dtype -> elements
        self.groups = {}                  # dtype -> its leaves' indices
        for i, leaf in enumerate(leaves):
            off = self.sizes.get(leaf.dtype, 0)
            self.slots.append((leaf.dtype, off, tuple(leaf.shape)))
            self.sizes[leaf.dtype] = off + leaf.numel()
            self.groups.setdefault(leaf.dtype, []).append(i)

    def check(self, tree):
        got = [(x.dtype, tuple(x.shape)) for x in tree_leaves(tree)]
        want = [(d, shape) for d, _off, shape in self.slots]
        if got != want:
            raise ValueError(f"tree layout {got} is not {want}")

    def pack(self, tree) -> dict:
        self.check(tree)
        parts = {d: [] for d in self.sizes}
        for x in tree_leaves(tree):
            parts[x.dtype].append(x.reshape(-1))
        return {d: torch.cat(p) for d, p in parts.items()}

    def unpack(self, flats: dict):
        views = (flats[d][off:off + math.prod(shape)].view(shape)
                 for d, off, shape in self.slots)
        return _unflatten(self.proto, views)

    def copy_into(self, flats: dict, tree) -> None:
        """Copy ``tree`` into the buffers ``flats``."""
        self.check(tree)
        leaves = tree_leaves(tree)
        views = None
        for d, idx in self.groups.items():
            n = self.sizes[d]
            base = leaves[idx[0]]._base
            if base is not None and base.dtype == d \
                    and base.storage_offset() == 0 and base.ndim == 1 \
                    and base.numel() >= n and all(
                        leaves[i]._base is base and leaves[i].is_contiguous()
                        and leaves[i].storage_offset() == self.slots[i][1]
                        for i in idx):
                flats[d].copy_(base[:n])
            else:
                views = views or tree_leaves(self.unpack(flats))
                for i in idx:
                    views[i].copy_(leaves[i])


class BeatGraphs:
    """One beat of the step as CUDA graphs, captured once from the beat
    generator of ``build_stream_step``: a graph for each stretch of the
    beat between two host actions (the three kernel B calls and the
    ``need_fit`` read), five in all. The host actions stay eager
    between the replays: kernel B through ``gplds.spd_solve``, looked
    up at every call, its solution copied into the buffer the next
    graph reads; the read, and on a first member the kernel fit, whose
    state is copied into the gathered source state the commit reads.

    The carry and the beat go in by copy into static buffers (the carry
    packed by dtype, ``Packing``), and the graphs' output (the new carry
    and the StepOut, packed the same way) comes out as a clone: the
    step never writes a tensor it was given or has returned."""

    def __init__(self, beat, carry, y, stream):
        dev = y.device
        self.pin = Packing(carry)
        self.flat_in = {d: torch.empty(n, dtype=d, device=dev)
                        for d, n in self.pin.sizes.items()}
        self.carry = self.pin.unpack(self.flat_in)
        self.y = torch.empty_like(y)
        self.graphs = []
        pool = torch.cuda.graph_pool_handle()

        def capture():
            g = torch.cuda.CUDAGraph()
            self.graphs.append(g)
            return torch.cuda.graph(g, pool=pool, stream=stream)

        self.host, self.pout, self.flat_out = capture_segments(
            beat(self.carry, self.y), capture)

    def __call__(self, carry, y, fit_read):
        with span("step.copy_in"):
            self.pin.copy_into(self.flat_in, carry)
            self.y.copy_(y)
        for i, g in enumerate(self.graphs):
            with span("step.seg", i + 1):
                g.replay()
            if i == len(self.host):
                break
            op, a, b, c = self.host[i]
            if op == "solve":
                c.copy_(gplds.spd_solve(a, b))
            else:
                new = fit_read(a, b, self.y)
                if new is not None:
                    tree_map(lambda dst, src: dst.copy_(src), b, new)
        with span("step.copy_out"):
            return self.pout.unpack({d: f.clone()
                                     for d, f in self.flat_out.items()})


def capture_segments(gen, capture):
    """Run the beat generator ``gen`` once, each stretch between two of
    its requests inside a fresh ``capture()`` context. Returns the host
    actions, each ``(op, a, b, c)``: ``("solve", spd, rhs, X)`` with X
    the buffer the next stretch reads the solution from, ``("fit",
    need_fit, src, None)``; the output's ``Packing``; and the output
    packed by it (a flat tensor a dtype), which the last stretch
    writes."""
    host, reply = [], None
    while True:
        with capture():
            try:
                msg = gen.send(reply)
            except StopIteration as stop:
                pout = Packing(stop.value)
                return host, pout, pout.pack(stop.value)
        op, a, b = msg
        if op == "solve":
            reply = torch.empty_like(b)
            host.append((op, a, b, reply))
        else:
            reply = b
            host.append((op, a, b, None))


_NO_SPAN = contextlib.nullcontext()


def _nospan(_name):
    return _NO_SPAN


def build_stream_step(T: int, K: int, *, est_limit, annealing: bool,
                      free_deg: float, trans_alpha: float,
                      start_alpha: float, kappa: float, gamma: float,
                      pin_lengthscale: float, fit_iters: int,
                      fit_lr: float, max_models: int, dtype,
                      x_basis, bound_lo, bound_hi):
    """Build the per-beat step ``step(carry, y) -> (carry, StepOut)``;
    y is one beat (T,) on the carry's device.

    A beat on the CPU runs eagerly, op by op (``step.eager``). On a
    CUDA device the first beat of a (K, T, dtype, device) runs eagerly
    on a side stream, the second captures the beat's CUDA graphs there
    (``BeatGraphs``) and every beat from then on replays them; a failed
    capture raises."""
    limit = float("inf") if est_limit is None else float(est_limit)
    fwd_abs = make_forward_step(T, limit, annealing, True, True, True,
                                False)
    fwd_birth = make_forward_step(T, limit, annealing, True, False, False,
                                  False)
    fwd_commit = make_forward_step(T, limit, annealing, True, True, False,
                                   False)
    cap = min(K, max_models) if max_models is not None else K
    fd = float(free_deg)
    lin_kw = dict(trans_alpha=trans_alpha, start_alpha=start_alpha,
                  kappa=kappa, gamma=gamma)

    def lin(carry, M, trans_counts):
        return sbd.elbo_linears_online(
            carry.rho, carry.omega, M, carry.M_rho,
            start_counts=carry.start_counts, trans_counts=trans_counts,
            **lin_kw)

    def fit(src: ClusterState, y) -> ClusterState:
        """The first member's kernel fit (kernel_fit._adam_fit on one
        lane, the lengthscale pinned) and the state rewrite, whose Gram
        kernel A writes."""
        s_fit, n_fit = _adam_fit(x_basis, y[None], bound_lo, bound_hi,
                                 fit_iters, fit_lr)
        st = gplds.index_state(src, 0)
        theta = KernelParams(
            outputscale=s_fit[0].to(st.theta.outputscale.dtype),
            lengthscale=torch.full_like(st.theta.lengthscale,
                                        pin_lengthscale),
            noise=n_fit[0].to(st.theta.noise.dtype))
        return gplds.stack_states([gplds.apply_kernel_fit(st, x_basis,
                                                          theta)])

    def fit_read(need_fit, src, y):
        """The beat's one host read; on a first member, the kernel fit
        of ``src`` (its new state), else None."""
        with span("step.fit_read"):
            need = bool(need_fit)
        if not need:
            return None
        with span("step.kernel_fit"):
            t_fit = time.perf_counter()
            new = fit(src, y)
            if y.device.type == "cuda":
                torch.cuda.synchronize(y.device)
            step.fits += 1
            step.fit_seconds += time.perf_counter() - t_fit
        return new

    def beat(carry: StreamState, y: torch.Tensor, sp=_nospan):
        """The beat as a generator of its host actions: it yields
        ``("solve", spd, rhs)`` at each kernel B call and takes the
        solution back, yields ``("fit", need_fit, src)`` before the
        commit and takes the commit's source state back, and returns
        ``(carry, StepOut)``. ``sp`` opens the sections' spans."""
        dev = y.device
        t, M = carry.t, carry.M
        ar = torch.arange(K, device=dev)
        eK1 = torch.arange(K + 1, device=dev)
        act = ar < M
        states = carry.states
        NEG = torch.full((), -1e30, dtype=dtype, device=dev)

        # ---- 1. scores against every cluster's last state ----
        with sp("step.score"):
            scores = torch.where(act, gplds.log_sq_error_last(states, y), NEG)
            m_best = torch.argmax(scores)

        # ---- 2. candidates: absorb into each slot, and the birth ----
        with sp("step.candidates"):
            ests = gplds.estimate_new(states, y).to(HDT)
            cand = yield from _append_state(states, y, fwd_abs)
            vf_c, vp_c, vl_c = (v.to(HDT) for v in gplds.q_lat_tail(cand, 1.0))
            lds_cand = gplds.lds_param_elbo(cand, fd).to(HDT)

            q_ord = torch.argsort(-torch.where(act, scores, -torch.inf),
                                  stable=True)
            m_template = q_ord.index_select(
                0, torch.clamp(M - 1, min=0).reshape(1))
            btempl = gplds.reinit_cluster_state(_take(states, m_template), fd)
            est_b = gplds.estimate_new(btempl, y)[0]
            b_state = yield from _append_state(btempl, y, fwd_birth)
            vf_b5 = (gplds.q_lat_tail(b_state, 0.5)[0][0] * 5.0).to(HDT)
            lds_b = gplds.lds_param_elbo(b_state, fd)[0].to(HDT)

        # ---- 3. one-sample ELBO totals (masked elbo_Linears) ----
        with sp("step.elbo"):
            n_all = carry.n.to(HDT)
            tot_n = torch.sum(n_all)
            sum_lds_n = torch.sum(torch.where(carry.n > 0, carry.lds * n_all,
                                              torch.zeros_like(n_all)))
            base_lds = sum_lds_n / torch.clamp(tot_n, min=1e-300)
            base_total = carry.q_sel_sum + carry.qlat_sel_sum \
                + lin(carry, M, carry.trans_counts) + base_lds

            # gate: does the birth slot win the emission argmax?
            gate = (est_b > torch.max(scores)) & (t > 0) & (M < cap)
            from_prev = eK1[:, None] == carry.prev_state

            # birth candidate total
            tc_b = carry.trans_counts \
                + (from_prev & (eK1[None, :] == M)).to(HDT)
            birth_total = (carry.q_sel_sum + est_b.to(HDT)) \
                + (carry.qlat_sel_sum + vf_b5) + lin(carry, M + 1, tc_b) \
                + (sum_lds_n + lds_b) / (tot_n + 1.0) - base_total

            # absorb candidate totals, every slot at once
            patch_t_val = torch.where(carry.n >= 1, vl_c, vf_c)
            prev_newval = torch.where(carry.n >= 2, vp_c, vf_c)
            patched_prev = carry.last_t == (t - 1)
            d_prev = torch.where(patched_prev, prev_newval - carry.qlat_last,
                                 torch.zeros_like(prev_newval))
            qlat_m = carry.qlat_sel_sum + patch_t_val + d_prev
            q_m = carry.q_sel_sum + ests
            tc_m = carry.trans_counts + (
                from_prev[None] & (eK1[None, None, :] == ar[:, None, None])
            ).to(HDT)                                           # (K, K+1, K+1)
            lds_tot_m = (sum_lds_n - carry.lds * n_all
                         + lds_cand * (n_all + 1.0)) / (tot_n + 1.0)
            absorb_total = q_m + qlat_m + lin(carry, M, tc_m) + lds_tot_m \
                - base_total

        # ---- 4. decision: the first absorb candidate (in q-order) that
        # beats the birth total, else birth (GPI_HDP.py:2484-2541) ----
        with sp("step.decide"):
            wins = (absorb_total > birth_total)[q_ord] & act
            any_win = torch.any(wins)
            first_win = _at(q_ord, torch.argmax(wins.to(torch.int8)))
            win = gate & any_win
            chosen_abs = torch.where(win, first_win, m_best)
            do_birth = gate & ~any_win
            slot = torch.where(do_birth, M, chosen_abs)
            slot1 = slot.reshape(1)

        # ---- 5. commit (GPI_HDP._include_one): absorb includes into the
        # current state; a birth's slot M still holds a pristine default
        # cluster (slots are never freed), so one gather covers both. A
        # first-ever member fits its kernel first (a host branch).
        with sp("step.commit"):
            src = _take(states, slot1)
            need_fit = ~carry.fitted.index_select(0, slot1) \
                & (carry.n.index_select(0, slot1) == 0)
            src = yield "fit", need_fit, src
            committed = yield from _append_state(src, y, fwd_commit)
            lds_new = gplds.lds_param_elbo(committed, fd).to(HDT)

            states2 = tree_map(
                lambda a, b: a.index_copy(0, slot1, b.to(a.dtype)),
                states, committed)
            at_slot = ar == slot
            n2 = carry.n + at_slot.to(carry.n.dtype)
            fitted2 = carry.fitted | at_slot
            last_t2 = torch.where(at_slot, t, carry.last_t)
            lds2 = torch.where(at_slot, lds_new, carry.lds)

            # cache bookkeeping (selected sums + per-cluster last values)
            ests_c = _at(ests, chosen_abs)
            q_add = torch.where(do_birth, est_b.to(HDT),
                                torch.where(win, ests_c,
                                            _at(scores, chosen_abs).to(HDT)))
            ptv_c = _at(patch_t_val, chosen_abs)
            zero = torch.zeros((), dtype=HDT, device=dev)
            qlat_add = torch.where(do_birth, vf_b5,
                                   torch.where(win,
                                               ptv_c + _at(d_prev, chosen_abs),
                                               zero))
            qlat_last2 = torch.where(
                at_slot, torch.where(do_birth, vf_b5,
                                     torch.where(win, ptv_c, zero)),
                carry.qlat_last)

            # counts
            first_beat = t == 0
            start2 = carry.start_counts + torch.where(
                first_beat, (eK1 == slot).to(HDT), zero)
            src_row = torch.where(first_beat, slot, carry.prev_state)
            trans2 = carry.trans_counts + (
                (eK1[:, None] == src_row) & (eK1[None, :] == slot)).to(HDT)
            M2 = torch.where(do_birth, M + 1, M)
            uid_chosen = torch.where(do_birth, carry.uid_next,
                                     _at(carry.slot_uid, slot))
            slot_uid2 = torch.where(at_slot, uid_chosen, carry.slot_uid)
            uid_next2 = torch.where(do_birth, carry.uid_next + 1,
                                    carry.uid_next)

        # ---- 6. popularity reorder (GPI_HDP.reorder) ----
        with sp("step.reorder"):
            key = torch.where(ar < M2, -n2, K + 1 + ar)
            perm = torch.argsort(key, stable=True)
            inv = torch.argsort(perm, stable=True)
            permK1 = torch.cat([perm, torch.full((1,), K, device=dev,
                                                 dtype=perm.dtype)])
            prev3 = _at(inv, slot).to(torch.int32)

            # ---- 7. deterministic HDP reinit (the L-BFGS refinement runs on
            # the host at chunk boundaries; GPI_HDP.py:2113-2141) ----
            big = M2 > 2
            rho2 = torch.where(big, sbd.create_init_rho_dyn(K, M2 - 1, HDT),
                               carry.rho)
            omega2 = torch.where(big, torch.where(
                ar < M2 - 1, torch.full_like(carry.omega, 1.0 + gamma),
                torch.zeros_like(carry.omega)), carry.omega)
            M_rho2 = torch.where(big, M2 - 1, carry.M_rho)

            new_carry = StreamState(
                states=_take(states2, perm), fitted=fitted2[perm], n=n2[perm],
                last_t=last_t2[perm], qlat_last=qlat_last2[perm],
                lds=lds2[perm], q_sel_sum=carry.q_sel_sum + q_add,
                qlat_sel_sum=carry.qlat_sel_sum + qlat_add, prev_state=prev3,
                start_counts=start2[permK1],
                trans_counts=trans2[permK1][:, permK1],
                rho=rho2, omega=omega2, M_rho=M_rho2.to(torch.int32),
                M=M2.to(torch.int32), t=t + 1, slot_uid=slot_uid2[perm],
                uid_next=uid_next2)
        return new_carry, StepOut(uid=uid_chosen, slot=prev3,
                                  birth=do_birth, M=M2)

    def eager(carry: StreamState, y: torch.Tensor):
        """One beat launched op by op, with today's spans."""
        count("stream.eager_beats")
        with span("stream.step"):
            gen = beat(carry, y, span)
            reply = None
            try:
                while True:
                    try:
                        op, a, b = gen.send(reply)
                    except StopIteration as stop:
                        return stop.value
                    if op == "solve":
                        reply = gplds.spd_solve(a, b)
                    else:
                        new = fit_read(a, b, y)
                        reply = b if new is None else new
            finally:
                gen.close()       # a raise above closes the beat's spans

    graphs = {}     # (K, T, dtype, device) -> warm-up stream or BeatGraphs

    def step(carry: StreamState, y: torch.Tensor):
        if y.device.type != "cuda":
            return eager(carry, y)
        key = (carry.n.shape[0], y.shape[-1], y.dtype, y.device)
        g = graphs.get(key)
        if g is None:
            # the warm-up beat, on the stream the capture will use, so
            # that the libraries' handles and workspaces exist for it
            s = torch.cuda.Stream(y.device)
            s.wait_stream(torch.cuda.current_stream(y.device))
            with torch.cuda.stream(s):
                out = eager(carry, y)
            torch.cuda.synchronize(y.device)
            graphs[key] = s
            return tuple(tree_map(torch.clone, t) for t in out)
        if not isinstance(g, BeatGraphs):
            g = graphs[key] = BeatGraphs(beat, carry, y, g)
        count("stream.graph_beats")
        with span("stream.step"):
            return g(carry, y, fit_read)

    step.fits, step.fit_seconds = 0, 0.0
    step.beat, step.eager, step.graphs = beat, eager, graphs
    return step


class OnlineStreamEngine:
    """Chunked host loop around the per-beat step.

    Parameters
    ----------
    model : HDPGPC
        Source of the configuration, the device and the default cluster.
    K : int
        Preallocated cluster slots (max clusters).
    chunk : int
        Beats between two host HDP refreshes. 1 reproduces the
        reference's per-beat rho/omega L-BFGS cadence.
    """

    def __init__(self, model, K: int = 16, chunk: int = 16):
        if model.n_outputs != 1:
            raise ValueError("stream engine: single lead only")
        if not model.cfg.bayesian_params:
            raise ValueError("stream engine: bayesian_params=True only")
        self.model = model
        self.K = K
        self.chunk = chunk
        self.dtype = model.dtype
        self.device = model.device
        self.step = None
        self.carry = None
        self.uids: list = []
        self.births: list = []

    def _build(self):
        """Build the step and the initial carry from the model's CURRENT
        defaults (deferred so that the float32 amplitude normalisation,
        which rescales the priors, can run on the first data)."""
        m = self.model
        g, h = m.cfg.gp, m.cfg.hdp
        dt, dev = self.dtype, self.device
        mm = m.cfg.max_models
        self.step = build_stream_step(
            m.Tb, self.K, est_limit=g.estimation_limit,
            annealing=g.annealing, free_deg=float(g.free_deg_mniw),
            trans_alpha=h.trans_alpha, start_alpha=h.start_alpha,
            kappa=h.kappa, gamma=h.gamma,
            pin_lengthscale=g.kernel_fit_pin_lengthscale,
            fit_iters=g.kernel_fit_iters, fit_lr=g.kernel_fit_lr,
            max_models=mm if mm is not None else self.K, dtype=dt,
            x_basis=torch.as_tensor(m.x_basis, dtype=dt, device=dev),
            bound_lo=torch.tensor(m._def_bound_sigma[0], dtype=dt,
                                  device=dev),
            bound_hi=torch.tensor(m._def_bound_sigma[1], dtype=dt,
                                  device=dev))
        self.carry = self._init_carry()

    def _padded_globals(self, glob):
        rho = np.zeros(self.K)
        om = np.zeros(self.K)
        rho[:glob.rho.shape[0]] = glob.rho
        om[:glob.omega.shape[0]] = glob.omega
        return (torch.as_tensor(rho, dtype=HDT, device=self.device),
                torch.as_tensor(om, dtype=HDT, device=self.device),
                torch.tensor(glob.rho.shape[0], dtype=torch.int32,
                             device=self.device))

    def _init_carry(self) -> StreamState:
        m, K, dev = self.model, self.K, self.device
        base = m._new_cluster().state
        states = tree_map(
            lambda a: a.expand((K,) + tuple(a.shape)).clone(), base)
        rho, omega, M_rho = self._padded_globals(m.glob)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        def f64(*shape):
            return torch.zeros(shape, dtype=HDT, device=dev)

        return StreamState(
            states=states,
            fitted=torch.zeros(K, dtype=torch.bool, device=dev),
            n=torch.zeros(K, dtype=torch.int32, device=dev),
            last_t=torch.full((K,), -1, dtype=torch.int32, device=dev),
            qlat_last=f64(K), lds=f64(K), q_sel_sum=f64(),
            qlat_sel_sum=f64(), prev_state=i32(0),
            start_counts=f64(K + 1), trans_counts=f64(K + 1, K + 1),
            rho=rho, omega=omega, M_rho=M_rho, M=i32(m.M), t=i32(0),
            slot_uid=torch.arange(K, dtype=torch.int32, device=dev),
            uid_next=i32(m.M))

    def _host_hdp_refresh(self):
        """reinit_globals + 4 x (theta update, rho/omega L-BFGS): the
        reference's per-beat global update (GPI_HDP.py:2113-2141) run at
        the chunk boundary on the fetched counts. Spans: ``stream.refresh``
        around ``refresh.fetch`` (the counts read to the host),
        ``refresh.lbfgs`` and ``refresh.upload`` (the globals back)."""
        with span("stream.refresh"):
            c = self.carry
            with span("refresh.fetch"):
                M = int(c.M)
                if M < 2:
                    return
                sc = c.start_counts[:M].cpu().numpy()
                tc = c.trans_counts[:M, :M].cpu().numpy()
            with span("refresh.lbfgs"):
                glob = self.model.glob
                if M > 2:
                    glob = sb.reinit_globals(glob, M - 1, tc, sc)
                for _ in range(4):
                    tt, st = sb.calc_theta_full(glob, tc, sc, M)
                    glob = sb.HDPGlobals(glob.rho, glob.omega, tt, st,
                                         glob.gamma, glob.trans_alpha,
                                         glob.start_alpha, glob.kappa)
                    glob = sb.optimise_globals(glob, M=M + 1)
                self.model.glob = glob
            with span("refresh.upload"):
                rho, omega, M_rho = self._padded_globals(glob)
                self.carry = self.carry._replace(rho=rho, omega=omega,
                                                 M_rho=M_rho)

    def run(self, Y: np.ndarray, hdp_refresh: bool = True) -> np.ndarray:
        """Stream a batch of beats (N, T) or (N, T, 1); returns the stable
        cluster ids (N,)."""
        Y = np.asarray(Y, np.float64)
        if Y.ndim == 3:
            Y = Y[:, :, 0]
        if self.dtype == torch.float32:
            Y = self.model._maybe_normalise_f32(Y[:, :, None])[:, :, 0]
        elif self.model._y_scale != 1.0:
            Y = Y / self.model._y_scale
        if self.step is None:
            self._build()
        Yd = torch.as_tensor(Y, dtype=self.dtype, device=self.device)
        N = Y.shape[0]
        # the per-beat outputs are read once, after the stream
        outs = []
        for i0 in range(0, N, self.chunk):
            for i in range(i0, min(i0 + self.chunk, N)):
                self.carry, o = self.step(self.carry, Yd[i])
                outs.append(torch.stack([o.uid.to(torch.int64),
                                         o.birth.to(torch.int64)]))
            if hdp_refresh:
                self._host_hdp_refresh()
        with span("stream.collect"):
            got = torch.stack(outs).cpu().numpy() if outs \
                else np.zeros((0, 2), np.int64)
        self.uids.extend(got[:, 0].tolist())
        self.births.extend(got[:, 1].astype(bool).tolist())
        return got[:, 0]

    def labels(self) -> np.ndarray:
        """Per-beat labels renumbered by the final slot order (the host
        path's resp_assigned[-1] convention)."""
        M = int(self.carry.M)
        slot_uid = self.carry.slot_uid[:M].cpu().numpy()
        uid_to_slot = {int(u): s for s, u in enumerate(slot_uid)}
        return np.asarray([uid_to_slot.get(int(u), -1) for u in self.uids])
