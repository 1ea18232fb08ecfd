"""The plain reference that decides `correct`: plain PyTorch and NumPy,
importing nothing of the program under test and nothing of JAX."""
