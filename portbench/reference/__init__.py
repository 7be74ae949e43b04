"""Plain float64 references (PyTorch and NumPy) that decide ``correct``.
They import nothing of the program, of JAX or of hdpgpc_tpu."""
