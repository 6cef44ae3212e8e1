"""A plain PyTorch path tracer that holds the program's pixels to account:
brute-force scene queries, yuki's materials, lights, samplers and
integrators, and no code of the program under test."""
