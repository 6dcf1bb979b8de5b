"""The benchmark of ``cudecomp_tpu_torch`` on NVIDIA GPUs.

One run is one cell of ``BENCHMARK.json`` (one configuration under one
traffic mix) on one seed::

    python3 -m bench_torch.run --workload c2c1024.ac --seed 7 \\
        --seconds 20 --trace 0

Everything that belongs to one configuration, one traffic mix or one
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the deployment's sizes, its source, what was
  cut from the source, the plain reference that checks it and the limits
  of that check;
* ``traffic/<traffic>.json``: the parameters of one mix, read by the
  driver it names (``drivers/<driver>.py``), which says what one
  iteration of the window is and what the check compares;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  end-to-end metric (from the window) and per per-layer metric (from the
  traced window);
* ``reference/<name>.py``: plain ``torch`` references, which import
  nothing of the program.

The yardstick (``yardstick.py``, ``trace.py``, the readers and the
references) sits here so that a change to the program cannot move it.
Nothing here imports ``jax`` or the JAX package.
"""
