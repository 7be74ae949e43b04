"""Driver of the offline sweep (``HDPGPC.include_batch``).

Set-up makes the record from the seed and runs one untimed sweep on its
first ``warmup_beats`` beats: the kernels load from the checkout's
build, and the refit, the forward-backward, the kernel fit and the HDP
update each run once (nothing in the port compiles at run time).

The window clusters whole records back to back, each a fresh model on
the same beats from the start of the record, swept until its partition
repeats, with the kernel-fit memo emptied first (a user's next record
shares no fit with the last). It closes at the end of the first record
that ends after ``--seconds``, so it holds whole records: a record's
sweeps differ (the first bears the clusters and fits their kernels),
and a window cut inside one would weigh them by where the clock fell.
``record_s`` = the window's seconds over its records.

The comparison (reference/offline.py) takes the last record's final
sweep: its partition, scores, clusters (with the beat each kernel fit
was seeded by), HDP globals and ELBO, and the forward-backward calls
of that sweep.

Traced runs (``--trace 1``) turn on the program's phase timers, wrap
the layers in harness spans, time the batched kernel fits, and profile
a slice of ``trace_slice_s`` seconds from the end of the window's first
sweep, with every kernel-B call in it a span named by its shape.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time

import numpy as np
import torch

from portbench import trace as tr
from portbench.frozen import data as fdata
from portbench.frozen.priors import compute_estimators_lds
from portbench.reference import offline as ref

MODEL_KEYS = ("ini_lengthscale", "bound_lengthscale", "ini_outputscale",
              "hmm_switch", "max_models", "bayesian_params",
              "reestimate_initial_params", "n_explore_steps",
              "free_deg_MNIV", "estimation_limit", "compute_dtype",
              "on_fragile")


def make_beats(traffic, seed):
    return fdata.fixed_morphology_beats(
        traffic["n_beats"], traffic["T"], traffic["n_clusters"],
        traffic["noise"], traffic["morph_seed"], seed)


def make_model(cfg, y, device):
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    std, std_dif, bs, bg = compute_estimators_lds(y)
    kw = {k: cfg[k] for k in MODEL_KEYS if k in cfg}
    kw["bound_lengthscale"] = tuple(kw["bound_lengthscale"])
    return HDPGPC(fdata.default_x_basis(y.shape[1]), n_outputs=y.shape[2],
                  ini_gamma=std_dif, ini_sigma=std, bound_sigma=bs,
                  bound_gamma=bg, verbose=False, device=device, **kw)


def _grid(y):
    return np.tile(np.arange(y.shape[1], dtype=np.float64), (y.shape[0], 1))


def setup(run):
    from hdpgpc_torch.models import hdpgpc as hmod
    y, z = make_beats(run.traffic, run.seed)
    st = dict(y=y, z=z, x=_grid(y), log=open(run.out_dir / "program.log",
                                             "w"))
    P = min(int(run.traffic["warmup_beats"]), y.shape[0])
    with contextlib.redirect_stdout(st["log"]):
        m = make_model(run.config, y[:P], run.device)
        m.include_batch(st["x"][:P], y[:P], it_limit=1)
    del m
    hmod._GLOBAL_KERNEL_FITS.clear()
    return st


class _Hooks:
    """What the window installs: the sweep-boundary hook on each model,
    the capture of the forward-backward calls and the kernel fits, and
    (traced runs) spans, kernel-B shapes and the profiled slice."""

    def __init__(self, run):
        from hdpgpc_torch.models import gplds
        from hdpgpc_torch.models import hdpgpc as hmod
        from hdpgpc_torch.ops import hmm as hmm_ops
        self.run = run
        self.boundaries = []          # host time of every sweep boundary
        self.fb_calls = []            # (sweep, packed, idx, pidx)
        self.fits = []                # (Ys, outputscale, noise)
        self.elbos = []               # ELBO of every sweep
        self.clusters = []            # M after every sweep
        self.kfit_prefetch_s = 0.0
        self.model = None
        self.stop_in = None           # (timed phase, seconds) of the stop
        self.slice = tr.Slice(run.traffic["trace_slice_s"], run.device) \
            if run.trace else None
        self.saved = [(hmm_ops, "fb_hard_packed_idx"),
                      (hmod, "fit_kernel_batch"), (hmod, "fit_kernel"),
                      (gplds, "spd_solve")]
        self.orig = {(id(o), a): getattr(o, a) for o, a in self.saved}
        hmm_ops.fb_hard_packed_idx = self._fb(hmm_ops.fb_hard_packed_idx)
        hmod.fit_kernel_batch = self._fit(hmod.fit_kernel_batch, True)
        hmod.fit_kernel = self._fit(hmod.fit_kernel, False)
        if run.trace:
            gplds.spd_solve = self._spd(gplds.spd_solve)

    def restore(self):
        for o, a in self.saved:
            setattr(o, a, self.orig[(id(o), a)])

    def _fb(self, fn):
        @functools.wraps(fn)
        def wrapper(packed):
            idx, pidx = fn(packed)
            self.fb_calls.append((len(self.boundaries), packed, idx, pidx))
            return idx, pidx
        return wrapper

    def _fit(self, fn, batch):
        @functools.wraps(fn)
        def wrapper(x_basis, Ys, bound_sigma, **kw):
            t0 = self._sync_clock()
            out = fn(x_basis, Ys, bound_sigma, **kw)
            thetas = out if batch else [out]
            if batch:
                self.kfit_prefetch_s += self._sync_clock() - t0
            self.fits.append((np.array(Ys, np.float64).reshape(
                len(thetas), -1), list(thetas)))
            return out
        return wrapper

    def _spd(self, fn):
        @functools.wraps(fn)
        def wrapper(spd, rhs):
            sl = self.slice
            if sl.active:
                n, T, R = rhs.shape
                dt = "float32" if spd.dtype == torch.float32 else "float64"
                with tr.span(f"spd_solve[{n},{T},{R},{dt}]"):
                    out = fn(spd, rhs)
                # the stop's host time goes to the innermost timed phase;
                # it is taken out of that phase again
                stack = self.model._timing_stack
                before = sl.overhead
                sl.maybe_stop()
                if stack and sl.overhead > before:
                    self.stop_in = (stack[-1][0], sl.overhead - before)
                return out
            return fn(spd, rhs)
        return wrapper

    def _sync_clock(self):
        if self.run.trace and self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        return time.perf_counter()

    def attach(self, model):
        """Sweep boundaries: counted, and the profiled slice starts at
        the first."""
        self.model = model
        log = model.metrics
        append = log.append

        def boundary(**kw):
            append(**kw)
            now = time.perf_counter()
            self.boundaries.append(now)
            self.elbos.append(kw.get("elbo", float("nan")))
            self.clusters.append(kw.get("n_clusters"))
            sl = self.slice
            if sl is not None and not sl.done:
                if sl.active:
                    sl.stop()
                else:
                    sl.start()
        log.append = boundary
        if self.run.trace:
            model._timing_on = True
            for meth, name in (("_full_refit_batch", "refit"),
                               ("_full_refit", "refit"),
                               ("_fb_hard", "fb"),
                               ("_hdp_global_update", "hdp_update"),
                               ("_maybe_kernel_fit", "kernel_fit"),
                               ("compute_q_elbo", "q_elbo"),
                               ("_seed_score", "seed_score")):
                setattr(model, meth, _spanned(getattr(model, meth), name))


def _spanned(fn, name):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with tr.span(name):
            return fn(*a, **k)
    return wrapper


def window(run, st):
    from hdpgpc_torch.models import hdpgpc as hmod
    from hdpgpc_torch.ops import kernels as kmod
    from hdpgpc_torch.ops import spd_solve as smod
    y, x = st["y"], st["x"]
    hooks = _Hooks(run)
    st["hooks"] = hooks
    dev = run.device
    cuda = dev.type == "cuda"
    timings = {}
    records = 0
    smod.spd_solve.launches = 0
    kmod.fused_rbf_gram.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model = None
    try:
        with contextlib.redirect_stdout(st["log"]):
            while time.perf_counter() - t0 < run.seconds:
                hmod._GLOBAL_KERNEL_FITS.clear()
                hooks.fb_calls = []
                model = None
                model = make_model(run.config, y, dev)
                hooks.attach(model)
                model.include_batch(x, y)
                records += 1
                for k, v in model.timings.items():
                    timings[k] = timings.get(k, 0.0) + v
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        overhead = hooks.slice.overhead if hooks.slice is not None else 0.0
    finally:
        hooks.restore()
        if hooks.slice is not None:
            hooks.slice.stop()
    sweeps = len(hooks.boundaries)
    c = run.ctx
    c.update(window_s=t1 - t0, sweeps=sweeps, records=records,
             attempted=sweeps,
             failed=sum(1 for e in hooks.elbos if not np.isfinite(e)),
             spd_launches=smod.spd_solve.launches,
             gram_launches=kmod.fused_rbf_gram.launches,
             peak_bytes=int(torch.cuda.max_memory_allocated(dev))
             if cuda else 0)
    st["model"] = model
    with open(run.out_dir / "sweeps.json", "w") as f:
        json.dump(dict(t=[b - t0 for b in hooks.boundaries],
                       M=hooks.clusters, elbo=hooks.elbos,
                       records=records), f)
    if run.trace:
        if hooks.stop_in is not None:
            name, secs = hooks.stop_in
            timings[name] = timings.get(name, 0.0) - secs
        c.update(timings=timings, kfit_prefetch_s=hooks.kfit_prefetch_s,
                 trace_overhead_s=overhead)
        s = hooks.slice.analyse(run.out_dir / "slice.json") \
            if hooks.slice.done else None
        if s is not None:
            c["slice"] = s
            c["busy_s"] = s["busy"]
            c["traced_s"] = s["wall"]
            c["breakdown"] = tr.breakdown(s)
            tr.dump(s, run.out_dir / "slice_summary.json")
        c["trace_tag"] = "offline"


def release(run, st):
    """The stopped model's last sweep and the window's captures, as
    plain arrays; the program's state is then freed."""
    m = st.pop("model")
    hooks = st.pop("hooks")
    last = len(hooks.boundaries) - 1
    fb = [(p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p),
           i.cpu().numpy(), q.cpu().numpy())
          for s, p, i, q in hooks.fb_calls if s == last]
    # each fit's seed beat, by the fitted values it gave
    seeded = {}
    for Ys, thetas in hooks.fits:
        for row, t in zip(Ys, thetas):
            seeded[(float(t.outputscale), float(t.noise))] = row
    clusters = []
    for cl in m.clusters[0][:m.resp_last.shape[1]]:
        s = cl.state
        th = (float(s.theta.outputscale), float(s.theta.noise))
        clusters.append(dict(
            seed_beat=seeded.get(th),
            **{k: getattr(s, k).double().cpu().numpy()
               for k in ("A", "Gamma", "C", "Sigma")}))
    g = m.glob
    st["cap"] = dict(
        y=st["y"], resp=np.asarray(m.resp_last),
        respPair=np.asarray(m.respPair_last),
        q=np.asarray(m.q_last)[:, :, 0], q_lat=np.asarray(m.q_lat_last)[
            :, :, 0], clusters=clusters,
        glob=dict(rho=np.asarray(g.rho), omega=np.asarray(g.omega),
                  trans_theta=np.asarray(g.trans_theta),
                  start_theta=np.asarray(g.start_theta)),
        elbo=float(m.elbo_last), fb=_sample(run, fb, "check_fb", 2))
    st["log"].close()
    del m, hooks
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _sample(run, items, key, stream):
    """At most ``traffic[key]`` of ``items``, drawn from the seed."""
    k = int(run.traffic[key])
    if len(items) <= k:
        return items
    rng = np.random.default_rng([run.seed, stream])
    return [items[i] for i in sorted(rng.choice(len(items), k,
                                                replace=False))]


def check(run, st, control=False):
    return ref.check(st["cap"], run.config, run.device, control)
