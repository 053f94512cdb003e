"""K1's share of its roofline over Point Transformer's traced predict steps:
the least seconds of its searches (each stage's self graph, the centroids'
searches and the 3-NN lists of the transitions up, positions read and
lists written once, at 3.35 TB/s; perfbench/yardstick_pt.py) over the
seconds ``knn_topk_kernel`` ran, in percent."""

from perfbench import yardstick, yardstick_pt

KERNELS = ("knn_topk_kernel",)


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    ran = trace.kernel_s(*KERNELS)
    if ran <= 0.0:
        return None
    least = 0.0
    for b in record["trace_batches"]:
        n_sampled = record["batches"][b][0]
        least += sum(yardstick_pt.k1_bytes(record["cfg"], int(n))
                     for n in n_sampled) / yardstick.PEAKS["hbm_bytes"]
    return 100.0 * least / ran
