"""The benchmark's plain reference: plain PyTorch, nothing of the program."""
