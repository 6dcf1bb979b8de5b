"""Per-layer readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``: ``read(traced) -> float | None`` from the traced window
(``harness.Traced``: the reduced trace, the number of iterations traced,
the configuration, the traffic and the device's name); None where the
trace holds nothing for the metric.  Times are device milliseconds per
iteration of the traffic."""
