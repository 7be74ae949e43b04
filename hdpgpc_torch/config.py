"""Frozen configuration dataclasses for hdpgpc_torch (a copy of
hdpgpc_tpu.config, so that the port imports no JAX).

The reference passes ~40 kwargs through one constructor
(GPI_HDP.py:100-174) and broadcasts scalars to per-cluster lists; here
the knobs live in frozen dataclasses so they are hashable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Per-cluster GP-LDS configuration.

    Mirrors the knobs of the reference's GPI_model / kernel setup
    (GPI_HDP.py:159-166 builds Constant*RBF+White kernels).
    """

    ini_lengthscale: float = 3.0
    bound_lengthscale: Tuple[float, float] = (1.0, 20.0)
    ini_outputscale: float = 300.0
    ini_sigma: float = 0.25          # diag of LDS observation noise Sigma
    ini_gamma: float = 0.01          # diag of LDS latent noise Gamma
    bound_sigma: Tuple[float, float] = (1e-10, 1e10)
    bound_gamma: Tuple[float, float] = (1e-1, 1e2)
    model_type: str = "dynamic"       # 'dynamic' | 'static'
    annealing: bool = True
    free_deg_mniw: int = 5            # MNIW prior dof (reference free_deg_MNIV)
    estimation_limit: Optional[int] = None
    # Kernel-fit (first-sample hyperparameter optimisation) settings;
    # reference: GPI.fit_torch (GPI.py:610-770), Adam lr=0.1, <=4000 iters,
    # early stop after 1000 iters on a 10-step loss plateau, lengthscale
    # written back pinned to 1.2 (GPI.py:711).
    kernel_fit_iters: int = 4000
    kernel_fit_lr: float = 0.1
    kernel_fit_pin_lengthscale: float = 1.2
    # float32 speed mode caps the Adam budget (the fitted outputscale
    # keeps creeping long after the plateau check engages, and f32
    # decisions are already approximate); effective budget is
    # min(kernel_fit_iters, kernel_fit_iters_f32) when compute_dtype is
    # float32. Validated on rec 100 (identical clustering); sweep other
    # records with examples/run_all_records.py before trusting it on a
    # new domain.
    kernel_fit_iters_f32: int = 1500
    # inducing-point (SGPR) kernel fit — the reference's ProjectedGPModel
    # path (GPI_models_pytorch.py:24-35, GPI.fit_torch reduced_points,
    # GPI.py:641-770): learnable inducing locations, 5000 Adam iters, NO
    # lengthscale pin on write-back. TPU-native divergence: the learned
    # locations tune the hyperparameters but the cluster keeps the full
    # static grid as its basis (fixed shapes; the reference shrinks the
    # basis by dropping collapsed points).
    inducing_points: bool = False
    kernel_fit_iters_inducing: int = 5000
    # variational (SVGP) inducing fit — the reference's
    # VarProjectedGPModel (GPI_models_pytorch.py:37-46): uncollapsed
    # whitened variational bound, learnable inducing locations and
    # q(u). Requires inducing_points=True; at the Gaussian-likelihood
    # optimum it coincides with the SGPR collapsed bound.
    variational_inducing: bool = False


@dataclasses.dataclass(frozen=True)
class HDPConfig:
    """HDP stick-breaking hyperparameters.

    Presets follow the reference's hdp_hyp schemes (GPI_HDP.py:274-291).
    """

    gamma: float = 1.0
    trans_alpha: float = 1.0
    start_alpha: float = 0.1
    kappa: float = 0.0

    @staticmethod
    def preset(name: str) -> "HDPConfig":
        if name == "less":
            return HDPConfig(0.01, 0.01, 0.01, 0.0)
        if name == "balanced":
            return HDPConfig(1.0, 1.0, 0.1, 0.0)
        if name == "more":
            return HDPConfig(10.0, 10.0, 1.0, 0.0)
        raise ValueError(f"unknown hdp preset {name!r}")


@dataclasses.dataclass(frozen=True)
class WarpConfig:
    """Monotone warp / alignment configuration.

    Mirrors amtgp_warping_system.Warping_system defaults
    (amtgp_warping_system.py:284-324): n_ctrl=8 control points, Adam
    lr=5e-2, smoothness / amplitude penalties mapped from theta.
    """

    n_ctrl: int = 8
    lr: float = 5e-2
    lambda_smooth: float = 200.0
    lambda_amp: float = 1e-3
    noise_warp: float = 1e-2
    bound_noise_warp: Tuple[float, float] = (1e-6, 1e2)
    train_iter_online: int = 250
    train_iter_batch: int = 50
    batch_size: int = 128
    mode: str = "rough"               # 'balanced' | 'fine' | 'rough'
    method: str = "greedy"            # 'standard' | 'greedy' | 'greedy_bound'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level model configuration (reference GPI_HDP.__init__)."""

    n_outputs: int = 1
    initial_clusters: int = 1
    max_models: Optional[int] = 100
    hmm_switch: bool = True
    bayesian_params: bool = True
    use_snr: bool = True
    share_gp: bool = False
    n_explore_steps: int = 10
    reestimate_initial_params: bool = False
    # variance-ranked lead reduction (GPI_HDP.py:703-714, :830-831)
    reduce_outputs: bool = False
    reduce_outputs_ratio: float = 1.0
    # 'float64' for reference parity (default); 'float32' is the
    # speed mode. Cluster decisions can differ slightly in f32.
    compute_dtype: str = "float64"
    # f32 speed-mode fragility guard: the offline sweep records the
    # smallest RELATIVE margin of every structural accept/reject ELBO
    # comparison; a run whose narrowest decision sits below this
    # tolerance is dtype-fragile (the same comparison in f64 could flip
    # — the rec-104-class divergence) and `model.f32_fragile` turns
    # True, recommending the f64 exact mode for that record.
    f32_guard_tol: float = 1e-4
    # What include_batch does when the guard fires at the end of a
    # float32 sweep (reference failure-fallback idiom,
    # OptimizerRhoOmega.py:59-95 — degrade to a safer path, loudly):
    #   'warn'         — print the warning, keep the f32 result
    #   'raise'        — raise FloatingPointError with instructions
    #   'fallback_f64' — re-run this batch in float64 exact mode on a
    #                    fresh model and adopt its result (slow, exact);
    #                    the f32 telemetry survives in model.f32_fallback
    on_fragile: str = "warn"
    hdp: HDPConfig = dataclasses.field(default_factory=HDPConfig)
    gp: GPConfig = dataclasses.field(default_factory=GPConfig)
    warp: WarpConfig = dataclasses.field(default_factory=WarpConfig)
    verbose: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        d = json.loads(s)
        d["hdp"] = HDPConfig(**d["hdp"])
        gp = d["gp"]
        for k in ("bound_lengthscale", "bound_sigma", "bound_gamma"):
            gp[k] = tuple(gp[k])
        d["gp"] = GPConfig(**gp)
        w = d["warp"]
        w["bound_noise_warp"] = tuple(w["bound_noise_warp"])
        d["warp"] = WarpConfig(**w)
        return ModelConfig(**d)
