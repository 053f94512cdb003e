"""Point Transformer V3's model FLOPs of every step of the window over the
window's seconds, in percent of the card's float32 peak (67 TFLOP/s): the
dense products, convolutions and attention at the counts the reference
took for each batch (perfbench/yardstick_ptv3.py). None without them."""

from perfbench import yardstick, yardstick_ptv3


def read(record):
    nb = len(record["batches"])
    per_batch = []
    for b in range(nb):
        slots = record.get("slots", {}).get(b)
        if slots is None:
            return None
        per_batch.append(yardstick_ptv3.batch_flops(record["cfg"], slots))
    total = sum(per_batch[j % nb] for j in range(record["steps"]))
    return 100.0 * total / record["window_s"] / yardstick.PEAKS["fp32_flops"]
