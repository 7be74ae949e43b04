from hdpgpc_torch.warp.monotone import (WarpPrior, WarpResult,
                                        build_batch_warp, make_warp_prior,
                                        warp_prior_score)

__all__ = ["WarpPrior", "WarpResult", "build_batch_warp", "make_warp_prior",
           "warp_prior_score"]
