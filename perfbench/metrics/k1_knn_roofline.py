"""K1's share of its roofline over the traced predict steps: the least
seconds its searches need (positions read once, neighbour lists written
once, at the card's 3.35 TB/s; perfbench/yardstick.py) over the seconds its
kernels ran (``knn_topk_kernel``, ``knn_ball_kernel``), in percent."""

from perfbench import yardstick

KERNELS = ("knn_topk_kernel", "knn_ball_kernel")


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    ran = trace.kernel_s(*KERNELS)
    if ran <= 0.0:
        return None
    least = 0.0
    for b in record["trace_batches"]:
        n_sampled, _, n_pad = record["batches"][b]
        least += sum(yardstick.k1_bytes(record["family"], record["cfg"], int(n), n_pad)
                     for n in n_sampled) / yardstick.PEAKS["hbm_bytes"]
    return 100.0 * least / ran
