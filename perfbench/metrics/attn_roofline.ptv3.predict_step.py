"""Point Transformer V3's patch attention against its FLOP floor over the
traced predict steps: ``4 C`` FLOPs a (kept query, key) pair of each
attention layer (perfbench/yardstick_ptv3.py, at the counts the reference
took for each traced batch) at the FP32 peak, over the seconds the
attention's kernels ran, in percent. The kernels are those of
``torch.nn.functional.scaled_dot_product_attention``'s memory-efficient
backend, which float32 takes on the card. None where none ran."""

from perfbench import yardstick, yardstick_ptv3

KERNELS = ("fmha_cutlassF",)


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    ran = trace.kernel_s(*KERNELS)
    if ran <= 0.0:
        return None
    least = 0.0
    for b in record["trace_batches"]:
        slots = record.get("slots", {}).get(b)
        if slots is None:
            return None
        least += yardstick_ptv3.attention_flops(record["cfg"], slots) / yardstick.PEAKS["fp32_flops"]
    return 100.0 * least / ran
