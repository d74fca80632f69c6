"""The plain reference of the benchmark: predicate masks and the exact
filtered k nearest neighbours, in plain PyTorch.

It imports nothing of the program under test (``repro_torch``), of JAX or
of the JAX package, and takes nothing the program made: it reads the
benchmark's own corpus and the plain description of each request."""
