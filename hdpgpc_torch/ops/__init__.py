"""Numerical operators of hdpgpc_torch: linear algebra, scans, HMM
messages, the hand-written CUDA kernels and their plain versions."""
