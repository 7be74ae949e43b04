"""The stream engine's beat as CUDA graphs (models/stream_online.py).

On the CPU (tier-1): the carry's packing by dtype round-trips bit for
bit, the stretches of a beat that the card captures make no host read
and no tensor from host data, and a CPU tensor's step builds no graph.

On the card (marked ``gpu``; each test skips without a CUDA device):
the growth stream through the graphed step and through the eager step,
with births and first-member kernel fits, at K = 16 float32, K = 16
float64 and K = 64 float32. Run there with
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_stream_graph.py``."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hdpgpc_torch.data.loader import default_x_basis, synthetic_growth_stream
from hdpgpc_torch.models import gplds
from hdpgpc_torch.models import stream_online as so
from hdpgpc_torch.models.hdpgpc import HDPGPC
from hdpgpc_torch.utils import metrics

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T_CPU = 24
aten = torch.ops.aten
# host reads (a synchronise on the card) and tensors made from host
# data (a copy from pageable memory): both refused inside a capture
HOST = {aten._local_scalar_dense.default, aten.nonzero.default,
        aten.is_nonzero.default, aten.equal.default,
        aten.lift_fresh.default, aten.lift_fresh_copy.default}


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST:
            raise AssertionError(f"{func} inside a captured stretch")
        return func(*args, **(kwargs or {}))


class _Copies(TorchDispatchMode):
    def __enter__(self):
        self.n = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is aten.copy_.default
        return func(*args, **(kwargs or {}))


def _model(y, dtype, device, K, fit_iters):
    """The growth stress configuration (chip_smoke.py's growth model),
    the kernel fit cut to ``fit_iters`` Adam steps."""
    w = y[:256]
    std = float(np.std(w))
    sd = float(np.std(np.diff(w, axis=0)))
    m = HDPGPC(default_x_basis(y.shape[1]), n_outputs=1,
               ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
               ini_gamma=sd, ini_sigma=std, ini_outputscale=4.0,
               bound_sigma=(std * 0.05, std * 0.2),
               bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
               hmm_switch=True, max_models=K, bayesian_params=True,
               estimation_limit=50, free_deg_MNIV=5, compute_dtype=dtype,
               device=device)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=fit_iters,
        kernel_fit_iters_f32=fit_iters))
    return m


def _engine(y, dtype, device, K, chunk, fit_iters=60):
    eng = so.OnlineStreamEngine(_model(y, dtype, device, K, fit_iters),
                                K=K, chunk=chunk)
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(y[:1])
    return eng


def _equal(a, b) -> bool:
    return all(x.dtype == z.dtype and x.shape == z.shape
               and torch.equal(x, z)
               for x, z in zip(gplds.tree_leaves(a), gplds.tree_leaves(b)))


# ---- on the CPU ----

@pytest.mark.parametrize("K", [6, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_packing_round_trip(dtype, K):
    """A carry after a few beats (a birth and a refresh in them), and
    its StepOut, packed by dtype and viewed back: every leaf equal bit
    for bit, in its dtype and shape; copied into buffers from the views
    (one copy a dtype), leaf by leaf (a carry of separate tensors), and
    both (a refresh's ``_replace`` breaks the views of one dtype): the
    same bits, in as many copies."""
    y, _z = synthetic_growth_stream(12, T_CPU, 2, seed=3, start_beat=0,
                                    interval=6)
    eng = _engine(y, dtype, "cpu", K, chunk=6)
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(y[1:])
    carry = eng.carry
    _c, out = eng.step(carry, torch.as_tensor(
        y[0] / eng.model._y_scale, dtype=eng.dtype))
    for tree in (carry, (carry, out)):
        pk = so.Packing(tree)
        flats = pk.pack(tree)
        assert set(flats) >= {torch.bool, torch.int32, torch.float64}
        back = pk.unpack(flats)
        assert type(back) is type(tree) and _equal(back, tree)
        assert all(v._base is flats[v.dtype] for v in gplds.tree_leaves(back))
    pk = so.Packing(carry)
    bufs = pk.pack(carry)
    packed = pk.unpack(pk.pack(carry))
    n64 = len(pk.groups[torch.float64])
    for src, copies in ((packed, len(bufs)), (carry, len(pk.slots)),
                        (packed._replace(rho=carry.rho.clone()),
                         len(bufs) - 1 + n64)):
        dst = {d: torch.zeros_like(f) for d, f in bufs.items()}
        with _Copies() as c:
            pk.copy_into(dst, src)
        assert c.n == copies
        assert _equal(pk.unpack(dst), carry)
    with pytest.raises(ValueError):
        pk.copy_into(bufs, packed._replace(lds=carry.lds[:-1]))


def test_captured_stretches_make_no_host_read():
    """The beat's stretches between its host actions, run as the card
    captures them (``capture_segments``) with every host read and every
    tensor made from host data refused: five stretches, the three
    kernel B calls (absorb candidates (4K), birth (2), commit (4)) and
    the need_fit read between them, and the output packed by dtype."""
    y, _z = synthetic_growth_stream(8, T_CPU, 2, seed=5, start_beat=0,
                                    interval=4)
    K = 6
    eng = _engine(y, "float32", "cpu", K, chunk=4)
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(y[1:])
    yb = torch.as_tensor(y[5] / eng.model._y_scale, dtype=eng.dtype)
    stretches = []

    def capture():
        stretches.append(1)
        return _NoHostRead()

    host, pout, flat = so.capture_segments(eng.step.beat(eng.carry, yb),
                                           capture)
    assert len(stretches) == 5
    assert [h[0] for h in host] == ["solve", "solve", "fit", "solve"]
    assert [h[2].shape[0] for h in host if h[0] == "solve"] == \
        [4 * K, 2, 4]
    assert host[2][1].dtype == torch.bool and host[2][1].numel() == 1
    assert set(flat) == set(pout.sizes)
    assert all(f.numel() == pout.sizes[d] for d, f in flat.items())
    assert len(pout.slots) == len(gplds.tree_leaves(eng.carry)) + 4
    assert eng.step.graphs == {}


def test_cpu_step_builds_no_graph():
    """On the CPU every beat is an eager beat: no graph, the counter
    ``stream.eager_beats`` a beat and no ``stream.graph_beats``, and
    the spans of the eager step (none of the card's)."""
    y, _z = synthetic_growth_stream(10, T_CPU, 2, seed=9, start_beat=0,
                                    interval=5)
    eng = _engine(y, "float64", "cpu", 6, chunk=5)
    metrics.reset()
    metrics.enable()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            eng.run(y[1:])
    finally:
        metrics.disable()
    snap = metrics.snapshot()
    metrics.reset()
    assert eng.step.graphs == {}
    assert snap["counters"] == {"stream.eager_beats": 9}
    names = {s["name"] for s in snap["spans"]}
    assert {"stream.step", "step.score", "step.commit",
            "step.fit_read"} <= names
    assert not any(n.startswith(("step.seg", "step.copy")) for n in names)


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and kernel B have no "
                    "CPU mode")
    return torch.device("cuda")


class _Counted:
    """A counting wrapper around ``gplds.spd_solve``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, spd, rhs):
        self.calls += 1
        return self.fn(spd, rhs)


def _clone(tree):
    return [x.clone() for x in gplds.tree_leaves(tree)]


def _same_bits(a, b, dtype):
    """Bit for bit, else (where a library takes another algorithm under
    capture) within 1e-6 relative in float32, 1e-12 in float64. Returns
    the worst relative gap."""
    worst = 0.0
    for x, z in zip(gplds.tree_leaves(a), gplds.tree_leaves(b)):
        assert x.dtype == z.dtype and x.shape == z.shape
        if torch.equal(x, z):
            continue
        assert x.is_floating_point(), "an integer or bool leaf differs"
        gap = ((x - z).abs() / z.abs().clamp(min=1e-30)).max().item()
        worst = max(worst, gap)
    assert worst <= (1e-6 if dtype == "float32" else 1e-12)
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("K,dtype", [(16, "float32"), (16, "float64"),
                                     (64, "float32")])
def test_graphed_step_matches_eager(cuda, K, dtype, monkeypatch):
    """576 growth-stream beats (a new morphology every 48 beats, eight
    in all; those born bring a first-member fit) through the graphed
    step and, on a second engine, through the eager step, chunks of 32
    with their refreshes: the same decisions, uids, births, M and HDP
    counts; each graphed beat's carry against the eager beat from the
    same input carry, bit for bit (or within 1e-6 / 1e-12); no carry
    given to or returned by the step changed afterwards; three kernel B
    calls a graphed beat, counted by a wrapper set after the capture;
    every beat after the first a graph beat."""
    n, chunk = 576, 32
    y, _z = synthetic_growth_stream(n, 90, 8, seed=11, start_beat=0,
                                    interval=48)
    g_eng = _engine(y, dtype, cuda, K, chunk)
    e_eng = _engine(y, dtype, cuda, K, chunk)
    e_eng.step = e_eng.step.eager
    step = g_eng.step
    kept, worst, calls = [], [0.0], []

    def lockstep(carry, yb):
        counted = gplds.spd_solve
        before = counted.calls if isinstance(counted, _Counted) else None
        new, out = step(carry, yb)
        if before is not None:
            calls.append(counted.calls - before)
        e_new, e_out = step.eager(carry, yb)
        worst[0] = max(worst[0], _same_bits((new, out), (e_new, e_out),
                                            dtype))
        if len(kept) < 12 and int(carry.t) % 47 == 1:
            kept.append((carry, _clone(carry), new, _clone(new)))
        return new, out

    g_eng.step = lockstep
    metrics.reset()
    metrics.enable()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            g_eng.run(y[1:chunk])
            assert len(step.graphs) == 1
            monkeypatch.setattr(gplds, "spd_solve",
                                _Counted(gplds.spd_solve))
            e_eng.run(y[1:chunk])
            for i0 in range(chunk, n, chunk):
                g_eng.run(y[i0:i0 + chunk])
                e_eng.run(y[i0:i0 + chunk])
    finally:
        metrics.disable()
    counters = metrics.snapshot()["counters"]
    metrics.reset()
    torch.cuda.synchronize()
    assert calls and set(calls) == {3}
    assert counters["stream.graph_beats"] == n - 1
    assert sum(g_eng.births) >= 2 and step.fits >= 2
    assert g_eng.uids == e_eng.uids and g_eng.births == e_eng.births
    np.testing.assert_array_equal(g_eng.labels(), e_eng.labels())
    gc, ec = g_eng.carry, e_eng.carry
    assert int(gc.M) == int(ec.M) >= 3
    for f in ("start_counts", "trans_counts", "n", "slot_uid"):
        assert torch.equal(getattr(gc, f), getattr(ec, f)), f
    _same_bits(gc, ec, dtype)
    assert len(kept) >= 8
    for given, given0, returned, returned0 in kept:
        assert all(torch.equal(a, b) for a, b in
                   zip(gplds.tree_leaves(given), given0))
        assert all(torch.equal(a, b) for a, b in
                   zip(gplds.tree_leaves(returned), returned0))
    print(f"K {K} {dtype}: worst relative gap graphed vs eager "
          f"{worst[0]:.3e}, births {sum(g_eng.births)}, fits {step.fits}")


@pytest.mark.gpu
def test_failed_capture_raises(cuda, monkeypatch):
    """A host read inside a captured stretch makes the capture fail, and
    the step raises (no silent fallback to the eager step)."""
    y, _z = synthetic_growth_stream(4, 90, 2, seed=2, start_beat=0,
                                    interval=2)
    eng = _engine(y, "float32", cuda, 16, chunk=4)
    score = gplds.log_sq_error_last

    def reads(state, yb):
        out = score(state, yb)
        float(out.sum())
        return out
    monkeypatch.setattr(gplds, "log_sq_error_last", reads)
    with pytest.raises(RuntimeError):
        with contextlib.redirect_stdout(io.StringIO()):
            eng.run(y[1:2])
