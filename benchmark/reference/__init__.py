"""Plain references of the benchmark: NumPy, SciPy and plain PyTorch, importing nothing of the program."""
