"""The deep frontend: SuperPoint extraction (``features.deep.frontend.extract_deep_batch``)
and the attentional matcher's verified match graph
(``features.deep.frontend.build_match_tables_deep``), built inside the
timed request and handed to ``run_sfm(match_tables=...)``. The networks
come from the repository's ``weights/``; every setting from the
configuration's frontend block."""

from __future__ import annotations

from sfmbench.harness import CellError

STREAMS = False     # StreamingReconstructor extracts with the DoG frontend only


def setup(prog):
    """The two networks on the device from ``weights/`` (both files must be
    there: no random weights), and the camera on the device."""
    import torch

    from eacham_tpu_torch.features.deep.frontend import load_frontend_params

    fe = prog.config["frontend"]
    if tuple(fe["normalize_size"]) != tuple(prog.size):
        raise CellError(f"frontend.normalize_size {fe['normalize_size']} is not the "
                        f"inputs' size {list(prog.size)}")
    superpoint, matcher, n_layers = load_frontend_params(device=prog.dev)
    for model in (superpoint, matcher):
        if model.weights_path is None:
            raise CellError(f"no weights for {type(model).__name__} under weights/: "
                            "superpoint.npz and lightglue.npz are needed")
    if n_layers != fe["n_layers"]:
        raise CellError(f"weights/lightglue.meta gives {n_layers} layers, "
                        f"the configuration {fe['n_layers']}")
    intr = torch.as_tensor(prog.intr, dtype=torch.float32, device=prog.dev)
    return {"superpoint": superpoint, "matcher": matcher, "intr": intr}


def kernels(config: dict) -> list[str]:
    return ["masked_attention"]


def extract(prog, images):
    from eacham_tpu_torch.features.deep.frontend import extract_deep_batch

    xy, desc, _, mask = extract_deep_batch(
        prog.frontend_state["superpoint"], images,
        max_keypoints=prog.config["frontend"]["max_keypoints"], device=prog.dev)
    return xy, desc, mask


def match_tables(prog, xy, desc, mask, opts, generator):
    from eacham_tpu_torch.features.deep.frontend import build_match_tables_deep

    fe, st = prog.config["frontend"], prog.frontend_state
    pairs = fe["pairs"]
    return build_match_tables_deep(
        st["matcher"], xy, desc, mask, prog.size, min_matches=opts.min_matches,
        pair_window=pairs["window"], retrieval_k=pairs["retrieval_k"], ladder=pairs["ladder"],
        verify=(st["intr"], generator, opts.max_repr_error, opts.verify_hyps),
        threshold=fe["threshold"], device=prog.dev)
