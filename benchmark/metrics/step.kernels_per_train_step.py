"""``step.kernels_per_train_step``: device kernels per step of a captured
train epoch: the kernels that the graph replays launched inside the
traced piece's ``sweep.train`` span, over those replays' steps."""


def read(record):
    t = record["trace"]
    replays = t["graph_replays"].get("sweep.train", 0)
    if not replays:
        return None
    return t["graph_kernels"].get("sweep.train", 0) / (replays * record["piece"]["train_steps"])
