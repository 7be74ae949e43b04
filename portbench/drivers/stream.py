"""Driver of the fused online stream engine (``OnlineStreamEngine``).

Set-up makes one growth stream from the seed (``warmup_beats`` beats
followed by ``window_beats`` more, every morphology available after the
warm-up), takes the model's priors from its first ``prior_beats`` beats
as the source takes them from its record, and streams the warm-up
through the engine, so that every morphology is born (and its kernel
fitted) before the window.

The window streams whole ``run()`` calls of ``chunk`` beats (each ends
in the engine's host HDP refresh) from the stream's beats after the
warm-up, over and over if the window outlasts them, until
``--seconds`` have passed, and ends in a device synchronise.
``beats_per_s`` = beats over the window's seconds.

The comparison (reference/stream.py) follows the engine from its own
state before ``check_steps`` beats drawn from the seed among the
window's first ``check_window_beats``, and before the set-up's last
birth, with every cluster's kernel fitted again on the beat that seeded
it, and checks ``check_refreshes`` of the window's HDP refreshes.

Traced runs wrap the step, the refresh and every kernel-B call in
harness spans, time each refresh (synchronised), and profile the
``trace_chunk``-th chunk of the window.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time

import numpy as np
import torch

from portbench import trace as tr
from portbench.frozen import data as fdata
from portbench.frozen.priors import compute_estimators_lds
from portbench.reference import stream as ref

MODEL_KEYS = ("ini_lengthscale", "bound_lengthscale", "ini_outputscale",
              "hmm_switch", "max_models", "bayesian_params",
              "reestimate_initial_params", "n_explore_steps",
              "free_deg_MNIV", "estimation_limit", "compute_dtype")


def setup(run):
    from hdpgpc_torch.models import stream_online as so
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    cfg, tf = run.config, run.traffic
    W = int(tf["warmup_beats"])
    y, _z = fdata.synthetic_growth_stream(
        W + int(tf["window_beats"]), tf["T"], tf["n_clusters"], run.seed,
        start_beat=0, interval=tf["interval"])
    std, std_dif, bs, bg = compute_estimators_lds(
        y[:cfg["prior_beats"], :, None])
    pri = dict(ini_gamma=std_dif, ini_sigma=std, bound_sigma=bs,
               bound_gamma=bg)
    kw = {k: cfg[k] for k in MODEL_KEYS}
    kw["bound_lengthscale"] = tuple(kw["bound_lengthscale"])
    model = HDPGPC(fdata.default_x_basis(tf["T"]), n_outputs=1,
                   verbose=False, device=run.device, **pri, **kw)
    eng = so.OnlineStreamEngine(model, K=cfg["K"], chunk=cfg["chunk"])
    log = open(run.out_dir / "program.log", "w")
    with contextlib.redirect_stdout(log):
        # beat 0 builds the step (it is never a birth); the set-up's last
        # birth (a kernel fit and a first member) is kept for the
        # comparison
        eng.run(y[:1])
        births = {}
        step = eng.step

        def step_w(carry, yb):
            new, out = step(carry, yb)
            if bool(out.birth):
                births["last"] = to_device((carry, new, out,
                                            int(carry.t)), "cpu")
            return new, out
        eng.step = step_w
        eng.run(y[1:W])
        eng.step = step
    M = int(eng.carry.M)
    print(f"portbench: set-up streamed {W} beats, M {M}, births "
          f"{sum(eng.births)}", file=sys.stderr)
    return dict(eng=eng, model=model, log=log, y=y, pri=pri,
                birth=births.get("last"), scale=float(model._y_scale))


class _Hooks:
    """Captures of the window: sampled steps, refreshes, and (traced
    runs) spans and refresh times."""

    def __init__(self, run, st, sample):
        from hdpgpc_torch.models import gplds
        self.run = run
        self.eng = st["eng"]
        self.sample = set(sample)
        self.beat = 0
        self.steps = {}
        self.refreshes = []
        self.refresh_s = []
        self.slice = tr.Slice(0.0, run.device) if run.trace else None
        step = self.eng.step
        refresh = self.eng._host_hdp_refresh
        self.gplds = gplds
        self.orig_spd = gplds.spd_solve

        def step_w(carry, y):
            i = self.beat
            self.beat += 1
            if self.slice is not None and self.slice.active:
                with tr.span("stream.step"):
                    out = step(carry, y)
            else:
                out = step(carry, y)
            if i in self.sample:
                self.steps[i] = to_device((carry, out[0], out[1]), "cpu")
            return out

        def refresh_w():
            c = self.eng.carry
            g = self.eng.model.glob
            t0 = self._clock()
            if self.slice is not None and self.slice.active:
                with tr.span("stream.refresh"):
                    refresh()
            else:
                refresh()
            self.refresh_s.append(self._clock() - t0)
            self.refreshes.append((c.M, c.start_counts, c.trans_counts, g,
                                   self.eng.model.glob))

        self.eng.step = step_w
        self.eng._host_hdp_refresh = refresh_w
        if run.trace:
            gplds.spd_solve = self._spd(gplds.spd_solve)

    def _clock(self):
        if self.run.trace and self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        return time.perf_counter()

    def _spd(self, fn):
        @functools.wraps(fn)
        def wrapper(spd, rhs):
            if self.slice.active:
                n, T, R = rhs.shape
                dt = "float32" if spd.dtype == torch.float32 else "float64"
                with tr.span(f"spd_solve[{n},{T},{R},{dt}]"):
                    return fn(spd, rhs)
            return fn(spd, rhs)
        return wrapper

    def restore(self):
        self.gplds.spd_solve = self.orig_spd


def window(run, st):
    from hdpgpc_torch.ops import spd_solve as smod
    eng, tf, cfg = st["eng"], run.traffic, run.config
    chunk = int(cfg["chunk"])
    rng = np.random.default_rng([run.seed, 3])
    sample = rng.choice(tf["check_window_beats"], tf["check_steps"],
                        replace=False)
    hooks = _Hooks(run, st, sample)
    st["hooks"] = hooks
    dev = run.device
    cuda = dev.type == "cuda"
    W = int(tf["warmup_beats"])
    pool = st["y"].shape[0] - W
    ys = []
    n0 = len(eng.uids)
    smod.spd_solve.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    beats = 0
    chunks = 0
    try:
        with contextlib.redirect_stdout(st["log"]):
            while time.perf_counter() - t0 < run.seconds:
                off = W + beats % pool
                Y = st["y"][off:off + chunk]
                sl = hooks.slice
                if sl is not None and chunks == tf["trace_chunk"]:
                    sl.start()
                    eng.run(Y)
                    sl.stop()
                    sl.units = Y.shape[0]
                else:
                    eng.run(Y)
                ys.append(Y)
                beats += Y.shape[0]
                chunks += 1
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    finally:
        hooks.restore()
    labels = np.asarray(eng.labels())[n0:]
    births = int(sum(eng.births[n0:]))
    print(f"portbench: window streamed {beats} beats in {chunks} chunks, "
          f"births {births}, M {int(eng.carry.M)}", file=sys.stderr)
    c = run.ctx
    c.update(window_s=t1 - t0, beats=beats, chunks=chunks,
             attempted=beats, failed=int(np.sum(labels < 0)),
             births=births, spd_launches=smod.spd_solve.launches,
             peak_bytes=int(torch.cuda.max_memory_allocated(dev))
             if cuda else 0)
    st.update(labels=labels, y_win=np.concatenate(ys))
    if run.trace:
        c["refresh_s"] = list(hooks.refresh_s)
        sl = hooks.slice
        s = sl.analyse(run.out_dir / "slice.json") if sl.done else None
        if s is not None:
            s["beats"] = sl.units
            c["slice"] = s
            c["busy_s"] = s["busy"]
            c["traced_s"] = s["wall"]
            c["breakdown"] = tr.breakdown(s)
            tr.dump(s, run.out_dir / "slice_summary.json")


def release(run, st):
    """Keep the sampled steps and refreshes; free the engine."""
    hooks = st.pop("hooks")
    tf = run.traffic
    steps = []
    if st["birth"] is not None:
        c_in, c_out, o, t = to_device(st["birth"], run.device)
        y = torch.as_tensor(st["y"][t] / st["scale"], device=run.device)
        steps.append((c_in, y, c_out, o))
    for i in sorted(hooks.steps):
        c_in, c_out, o = to_device(hooks.steps[i], run.device)
        y = torch.as_tensor(st["y_win"][i] / st["scale"], device=run.device)
        steps.append((c_in, y, c_out, o))
    rng = np.random.default_rng([run.seed, 4])
    refs = hooks.refreshes
    pick = sorted(rng.choice(len(refs), min(len(refs),
                                             tf["check_refreshes"]),
                             replace=False)) if refs else []
    refreshes = []
    for j in pick:
        M, sc, tc, g0, g1 = refs[j]
        if int(M) < 2:
            continue
        refreshes.append((int(M), sc.double().cpu().numpy(),
                          tc.double().cpu().numpy(), _glob(g0), _glob(g1)))
    # a cluster's kernel is fitted on its first member: the beat that
    # seeded it, by the cluster's stable id
    streamed = np.concatenate([st["y"][:tf["warmup_beats"]], st["y_win"]])
    seeds = {}
    for i, u in enumerate(st["eng"].uids):
        seeds.setdefault(int(u), streamed[i] / st["scale"])
    st["cap"] = dict(steps=steps, refreshes=refreshes, seed_beats=seeds)
    st["log"].close()
    del hooks
    st.pop("eng")
    st.pop("model")
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def to_device(tree, device):
    """A copy of a tree of tuples and NamedTuples of tensors on
    ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = [to_device(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree


def _glob(g):
    return dict(rho=np.asarray(g.rho), omega=np.asarray(g.omega),
                trans_theta=np.asarray(g.trans_theta),
                start_theta=np.asarray(g.start_theta))


def check(run, st, control=False):
    cfg, pri = run.config, st["pri"]
    s2 = st["scale"] ** 2
    h = cfg["hdp"]
    rcfg = dict(K=cfg["K"], est_limit=cfg["estimation_limit"],
                free_deg=cfg["free_deg_MNIV"], max_models=cfg["max_models"],
                gamma=h["gamma"], trans_alpha=h["trans_alpha"],
                start_alpha=h["start_alpha"], kappa=h["kappa"],
                bound_lo=pri["bound_sigma"][0] / s2,
                bound_hi=pri["bound_sigma"][1] / s2,
                fit_iters=cfg["fit_iters"], fit_lr=cfg["fit_lr"],
                pin_lengthscale=cfg["pin_lengthscale"])
    return ref.check(st["cap"], rcfg, run.device, control)
