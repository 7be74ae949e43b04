from hdpgpc_torch.parallel.records import (build_sharded_vi_step,
                                           init_record_states, make_mesh,
                                           shard_records, sharded_vi_step)

__all__ = ["build_sharded_vi_step", "init_record_states", "make_mesh",
           "shard_records", "sharded_vi_step"]
