"""Host waits for the card inside the traced request's sweep
(``sfm.device_loop`` and every span in it), per frame it registered (its
count ``registered``). The waits are the program's count ``readbacks``:
each read of device values and each upload from pageable memory on the
sweep and BA path, counted where it is made. On the card every
synchronization that ``torch.cuda.set_sync_debug_mode("warn")`` flags inside
the sweep is counted, and nothing else (tests/test_torch_trace.py holds
the two equal)."""

from sfmbench import spans


def read(ctx):
    tree = spans.batch(ctx)
    if tree is None:
        return None
    sweep = tree.named("sfm.device_loop")
    registered = tree.count(sweep, "registered")
    if not registered:
        return None
    return tree.count(sweep, "readbacks", deep=True) / registered
