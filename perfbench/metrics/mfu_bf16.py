"""``mfu_bf16``: the LM serving step's share of the card's bf16 peak, in
%: the operations of the turns computed in the traced sub-window
(``perfbench/lfm2_counts.py``, from the server's ``tokens``,
``attn_ctx_tokens`` and ``samples`` counters read at its ends), over its
wall, over 989 TFLOP/s (H100 SXM, dense bf16, 700 W).  Nothing without a
trace in which a device operation ran, or where the server counts no
tokens."""

from perfbench import lfm2_counts


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0 or not run.trace_counters:
        return None
    a, b = run.trace_counters
    if "attn_ctx_tokens" not in b:
        return None
    ops = lfm2_counts.flops(run.config, b["tokens"] - a["tokens"],
                            b["attn_ctx_tokens"] - a["attn_ctx_tokens"],
                            b["samples"] - a["samples"])
    return 100.0 * ops / tr.window_s / lfm2_counts.BF16_PEAK_FLOPS
