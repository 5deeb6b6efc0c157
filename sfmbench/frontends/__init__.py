"""The program side of each frontend kind, one module a kind
(``configs/*.json``'s ``frontend.kind``), found by name as ``inputs/<kind>.py``
is. With ``entry.py`` these are the only modules of the benchmark that
import the program (``eacham_tpu_torch``), and they import it inside their
functions.

Each module has:

- ``STREAMS``: True where ``sfm.streaming.StreamingReconstructor`` runs
  this frontend itself, so that the kind can serve an open-loop cell;
- ``setup(prog) -> state``: the kind's models and constants on the device,
  made in ``Program.__init__`` (its time falls in ``setup_s``); kept as
  ``prog.frontend_state``;
- ``kernels(config) -> list[str]``: the kernels ``Program.build`` builds
  (names of ``eacham_tpu_torch.ops.build``);
- ``extract(prog, images) -> (xy, desc, mask)``: the features of the frames;
- ``match_tables(prog, xy, desc, mask, opts, generator) -> 6-tuple | None``:
  the verified match graph that ``run_sfm`` takes as ``match_tables``, built
  inside the timed request, or None where ``run_sfm`` builds its own graph.
  ``generator`` is the request's RANSAC generator, the one ``run_sfm`` is
  then handed, so that a kind's epipolar verification draws as ``run_sfm``'s
  own would.

The plain reference that judges a kind's output is
``reference/frontends/<kind>.py``.
"""
