"""The plain reference of each frontend kind, one module a kind
(``configs/*.json``'s ``frontend.kind``; ``harness.frontend_kind`` finds it
beside the program's ``frontends/<kind>.py``). Like the rest of
``reference/`` it imports nothing of the program.

Each module has:

- ``judge_frontend(images, out, frames, fe, control) -> dict``: the frontend's
  numbers on the sampled ``frames``, the program's features (``out``'s
  ``xy``, ``desc``, ``mask``) against the kind's features re-derived from
  the images (``fe``: the configuration's frontend block; ``control``: the
  configuration's ``control["frontend"]``);
- ``reference_matches(out, pairs, spec, control) -> (match_j, valid,
  substitute)``: the reference's matches on the program's real pairs, and
  the control's (match_j, valid) in the program's place where ``control``
  (``control["matcher"]``) replaces the matcher, else None.
"""
