"""Runnable, self-checking walkthroughs of the library (the JAX package's
``examples/``): ``python -m cudecomp_tpu_torch.examples.<name>``; see
``README.md`` beside this file."""
