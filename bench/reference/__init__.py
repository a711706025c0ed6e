"""Plain references of the benchmark's models, in PyTorch; they import
nothing of the program."""
