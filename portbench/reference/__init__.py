"""Plain PyTorch references of the benchmark's cells: they import neither
JAX nor the program, and take from the program only the outputs they
judge."""
