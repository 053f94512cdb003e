"""Model FLOPs of every step of the window over the window's seconds, in
percent of the card's float32 peak (67 TFLOP/s): the dense products the
architecture defines at each step's real counts (perfbench/yardstick.py),
for a train step the forward, the weight gradients and the input gradients
that reach a weight. Serves ``mfu_pct.<cells>``. PointNet++'s predict count
needs the valid neighbour slots of its set abstractions, which the
reference's ball queries count; without them the metric is left out. A
train step of a family the yardstick has no train count for raises."""

from perfbench import yardstick


def batch_flops(record, b):
    n_sampled, _, n_pad = record["batches"][b]
    cfg, family = record["cfg"], record["family"]
    if record.get("kind") == "train":
        if family != "randla_net":
            raise NotImplementedError(f"no train FLOP count for {family!r}")
        return sum(yardstick.randla_flops(cfg, int(n), train=True) for n in n_sampled)
    if family == "randla_net":
        return sum(yardstick.randla_flops(cfg, int(n)) for n in n_sampled)
    slots = record.get("slots", {}).get(b)
    if slots is None:
        return None
    return (sum(yardstick.pointnet2_flops(cfg, int(n), n_pad, [0] * len(slots)) for n in n_sampled)
            + yardstick.pointnet2_flops(cfg, 0, n_pad, slots))


def read(record):
    nb = len(record["batches"])
    per_batch = [batch_flops(record, b) for b in range(nb)]
    if any(f is None for f in per_batch):
        return None
    total = sum(per_batch[j % nb] for j in range(record["steps"]))
    return 100.0 * total / record["window_s"] / yardstick.PEAKS["fp32_flops"]
