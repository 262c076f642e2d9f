"""The plain reference the benchmark holds the program to (plain PyTorch and
NumPy; it imports nothing of the program)."""
