"""One reader a metric, named as the metric: ``read(ctx) -> float | None``.

``ctx`` holds what the run recorded: ``requests`` (the closed loop's
records: frames, registered, ``extract_s``, ``total_s``, ``run_sfm``'s
``seconds``, ``profiled``), ``window_s``, ``setup_s``, ``stream`` (the open
loop's per-frame ``latencies``, ``failed`` and ``chunks``), ``trace`` (the
profiled request reduced by ``devtrace``) and ``traced_request``. A reader
that finds nothing to read returns None, and the metric is left out.
"""
