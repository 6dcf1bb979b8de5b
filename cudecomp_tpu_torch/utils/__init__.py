"""Host-side helpers: arrays, build, logging, oracles, tracing."""
