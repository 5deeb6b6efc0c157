"""Input generators, one module a kind (``configs/*.json``'s ``inputs.kind``).

Each module has ``make(params: dict, seed: int) -> dict`` that returns
numpy arrays made on the host from the seed: what the program is handed
and the exact ground truth the checks judge it by. They are frozen copies
of the repository's recipes, so that no later change of the program moves
the workload.
"""
