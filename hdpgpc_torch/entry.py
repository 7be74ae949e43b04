"""Entry points: one cluster refit on a device, and the multi-record
step over a process group (counterpart of the repository's
``__graft_entry__``).

    python -c "from hdpgpc_torch.entry import dryrun_multichip; \\
               dryrun_multichip(2, device='cpu')"

``entry()`` returns the flagship model's compute kernel (one fused
GP-LDS cluster refit: Kalman loop, MNIW updates, RTS and scoring) and
its inputs at T = 90, N = 64, made with numpy from seed 0.
``dryrun_multichip(n)`` runs one full multi-record VI step with the HDP
theta update over an n-rank ``torch.distributed`` group, one record a
rank: NCCL and one card a rank by default, gloo on the CPU with
``device="cpu"`` (the counterpart of JAX's virtual CPU mesh).
"""

from __future__ import annotations

import os
import socket
import tempfile

import numpy as np
import torch

from hdpgpc_torch.device import DEFAULT_DEVICE, resolve_device

# each rank process must finish its step in this many seconds
RANK_TIMEOUT_S = 600


def entry(device=DEFAULT_DEVICE):
    """(fn, (Y, resp, state)): ``fn(Y, resp, state)`` is one cluster's
    refit returning (q, q_lat, f_last)."""
    from hdpgpc_torch.models import gplds
    from hdpgpc_torch.ops.kernels import KernelParams
    dev = resolve_device(device)
    T, N = 90, 64
    state = gplds.init_cluster_state(
        torch.arange(T, dtype=torch.float64, device=dev),
        KernelParams(1.0, 1.2, 0.05), 0.01, 0.25, 5.0)
    rng = np.random.default_rng(0)
    Y = torch.as_tensor(rng.standard_normal((N, T)), device=dev)
    resp = torch.as_tensor((rng.random(N) < 0.5).astype(np.float64),
                           device=dev)
    refit = gplds.build_refit(T)

    def fn(Y, resp, state):
        res = refit(Y, resp, state)
        return res.q, res.q_lat, res.state.f_last

    return fn, (Y, resp, state)


def dryrun_inputs(R: int, N: int = 16, T: int = 24, K: int = 3,
                  seed: int = 0) -> dict:
    """The dry run's records (numpy): beats, hard responsibilities and
    their transition pairs from random labels, the initial sticks."""
    from hdpgpc_torch.ops import stick_breaking as sb
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((R, N, T))
    z = rng.integers(0, K, (R, N))
    respPair = np.zeros((R, N, K, K))
    respPair[:, np.arange(1, N)[None, :], z[:, :-1], z[:, 1:]] = 1.0
    return dict(Y=Y, resp=np.eye(K)[z], respPair=respPair,
                rho=np.tile(sb.create_init_rho(K), (R, 1)))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init_method, device, inputs_path, out_dir,
               step_kw):
    """One rank: join the group, run the step on this rank's block of
    the records, write its outputs to ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist
    from hdpgpc_torch.parallel import records
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        # the ranks are the parallelism: one thread each
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    try:
        group = dist.group.WORLD
        d = dict(np.load(inputs_path))
        R, N, T = d["Y"].shape
        K = d["resp"].shape[2]
        states = records.init_record_states(R, K, T, device=dev)
        step = records.build_sharded_vi_step(T, K, device=dev, group=group,
                                             **step_kw)
        hdp = step_kw.get("hdp_update", False)
        a4, a5 = (("rho", "respPair") if hdp else ("start_log_pi",
                                                   "trans_log_pi"))
        q, q_lat, resp2, respPair2, elbo, states2 = step(
            *[records.shard_records(d[k], group) for k in ("Y", "resp")],
            records.shard_records(states, group),
            records.shard_records(d[a4], group),
            records.shard_records(d[a5], group))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 q=q.cpu().numpy(), q_lat=q_lat.cpu().numpy(),
                 resp=resp2.cpu().numpy(), respPair=respPair2.cpu().numpy(),
                 elbo=elbo.cpu().numpy())
    finally:
        dist.destroy_process_group()


def run_on_ranks(n: int, inputs: dict, device=DEFAULT_DEVICE,
                 timeout: float = RANK_TIMEOUT_S, **step_kw) -> dict:
    """One multi-record step over an n-rank group of spawned processes:
    rank r takes its contiguous block of the records in ``inputs``
    (``dryrun_inputs``' keys; ``start_log_pi`` and ``trans_log_pi``
    without ``hdp_update``). Returns the blocks' outputs joined along
    the records (q, q_lat, resp, respPair) and every rank's ELBO."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards; torch sees "
                           f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.npz")
        np.savez(path, **inputs)
        init = f"tcp://localhost:{_free_port()}"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, init, dev.type, path, tmp, step_kw))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.terminate()
                p.join()
        if hung:
            raise RuntimeError(f"{len(hung)} of {n} ranks did not finish in "
                               f"{timeout} s")
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(n)]
    joined = {k: np.concatenate([o[k] for o in outs])
              for k in ("q", "q_lat", "resp", "respPair")}
    joined["elbo"] = np.array([float(o["elbo"]) for o in outs])
    return joined


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> dict:
    """One full multi-record VI training step (the K cluster refits of
    every record, the HDP theta update on the device, forward-backward
    and the ELBO) over an n-rank group, one record a rank."""
    R, K = n_devices, 3
    inputs = dryrun_inputs(R, K=K)
    out = run_on_ranks(n_devices, inputs, device=device, hdp_update=True,
                       trans_alpha=1.0, start_alpha=0.1, kappa=0.0)
    if not np.all(np.isfinite(out["elbo"])):
        raise RuntimeError(f"non-finite ELBO {out['elbo']}")
    if np.ptp(out["elbo"]) != 0.0:
        raise RuntimeError(f"the ranks' ELBOs differ: {out['elbo']}")
    if out["q"].shape != (R, inputs["Y"].shape[1], K):
        raise RuntimeError(f"q of shape {out['q'].shape}")
    print(f"dryrun_multichip OK: {n_devices} ranks ({device}), "
          f"elbo={float(out['elbo'][0]):.3f}")
    return out
