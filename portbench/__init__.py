"""Benchmark of hdpgpc_torch on NVIDIA GPUs (see BENCHMARK.json)."""
