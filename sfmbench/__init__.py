"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

    python3 sfmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``inputs/<kind>.py``, ``limits/<workload>.json``, and
for a configuration's ``frontend.kind`` the program's side
``frontends/<kind>.py`` and the plain reference's
``reference/frontends/<kind>.py``.
"""
