"""The plain reference: exact top-l by brute force, in plain PyTorch.

Imports nothing of the program.  It makes the points again from the
seed, chunk by chunk, with the benchmark's own generator, so it holds
no second copy of the point set and reads nothing the program made.
"""
