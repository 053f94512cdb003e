"""K9's share of its roofline over Point Transformer's traced predict steps:
the least seconds of the vector-attention layers over the seconds
``vector_attention_kernel`` ran, in percent. None where K9 never ran.

The least seconds are bytes at 3.35 TB/s (a FLOP floor at the FP32 peak
would be beaten by products on the tensor cores), over the real points of
each stage (``yardstick_pt.stages``), ``blocks[i]`` layers at stage i: a
layer reads q, k and v once, the graph's int32 index once (``min(nsample,
m)`` slots a point, as the K1 floor counts them) and the positions once,
and writes y once; its parameters count nothing."""

from perfbench import yardstick, yardstick_pt

KERNELS = ("vector_attention_kernel",)


def layer_bytes(cfg: dict, n: int) -> float:
    """Least bytes of the attention layers of one cloud of ``n`` real points."""
    total = 0
    for m, c, k, blocks in zip(yardstick_pt.stages(cfg, n), cfg["planes"], cfg["nsample"],
                               cfg["blocks"]):
        total += blocks * m * (4 * c * 4 + min(k, m) * 4 + 3 * 4)
    return float(total)


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
        least += sum(layer_bytes(record["cfg"], int(n))
                     for n in n_sampled) / yardstick.PEAKS["hbm_bytes"]
    return 100.0 * least / ran
