"""Plain PyTorch references of the benchmark's configurations.  They import
nothing of the program: each works the program's results out again from the
inputs the benchmark made (weights, tokens, cached contexts)."""
