"""The flash-attention forward kernel's share of its roofline: the least
time of one launch (``work.bound_s`` of its FLOPs and bytes, counted from
the shapes) over its mean device time per launch in the trace, %."""
from perfbench.harness import work
from perfbench.harness.inputs import head_dim

#: the port's flash-attention forward kernels (csrc/flash_attention.cu)
KERNELS = ("fa_wgmma_kernel", "fa_fwd_kernel")


def read(r):
    trace = r.get("trace")
    if not trace:
        return None
    n, secs = 0, 0.0
    for name, (count, s) in trace["kernels"].items():
        if any(k in name for k in KERNELS):
            n, secs = n + count, secs + s
    if not n:
        return None
    a = r["arch"]
    flops, nbytes = work.flash_attention_fwd(
        r["batch"], a["num_heads"], a["num_kv_heads"], r["seq"], head_dim(a),
        a["window_size"], a["dtype"])
    least, _ = work.bound_s(nbytes, flops, a["dtype"])
    return 100.0 * least / (secs / n)
