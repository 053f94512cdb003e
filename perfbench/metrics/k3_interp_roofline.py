"""K3's share of its roofline over the traced predict steps: the least
seconds of the full-cloud interpolation (positions, sampled logits read and
full-cloud logits written once, and the weighting's arithmetic;
perfbench/yardstick.py) over the seconds ``knn_interp_kernel`` ran, in
percent."""

from perfbench import yardstick

KERNELS = ("knn_interp_kernel",)


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    ran = trace.kernel_s(*KERNELS)
    if ran <= 0.0:
        return None
    k, c = record["interp_k"], record["cfg"]["num_classes"]
    least = 0.0
    for b in record["trace_batches"]:
        n_sampled, n_full, _ = record["batches"][b]
        least += sum(yardstick.k3_bound_s(int(s), int(f), k, c)
                     for s, f in zip(n_sampled, n_full))
    return 100.0 * least / ran
