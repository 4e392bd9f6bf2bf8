"""The flat-buffer layout and the mixing round of the port
(counterpart of ``repro.dist``; the global view only)."""
