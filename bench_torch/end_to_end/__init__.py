"""End-to-end readers, one file per metric of ``BENCHMARK.json``'s
``end_to_end``: ``read(window) -> float | None`` from the measured window
(``harness.Window``); None where the window holds nothing to read."""
