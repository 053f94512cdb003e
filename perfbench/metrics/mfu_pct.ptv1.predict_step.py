"""Point Transformer's model FLOPs of every step of the window over the
window's seconds, in percent of the card's float32 peak (67 TFLOP/s): the
dense products at each step's real counts and at the valid slots the
reference's searches counted for its batch (perfbench/yardstick_pt.py).
None without those slots."""

from perfbench import yardstick, yardstick_pt


def read(record):
    cfg, nb = record["cfg"], len(record["batches"])
    per_batch = []
    for b in range(nb):
        slots = record.get("slots", {}).get(b)
        if slots is None:
            return None
        n_sampled = record["batches"][b][0]
        per_batch.append(sum(yardstick_pt.point_flops(cfg, int(n)) for n in n_sampled)
                         + yardstick_pt.slot_flops(cfg, slots))
    total = sum(per_batch[j % nb] for j in range(record["steps"]))
    return 100.0 * total / record["window_s"] / yardstick.PEAKS["fp32_flops"]
