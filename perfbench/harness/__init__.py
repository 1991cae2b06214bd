"""The benchmark's own machinery: the manifest and the files it names,
the run's environment, the port's objects built from a configuration,
the comparison that decides `correct`, the traced window and the result
line. Nothing here imports JAX or the JAX package; the port
(`lsenerf_tpu_torch`) is imported only by `program.py`."""
