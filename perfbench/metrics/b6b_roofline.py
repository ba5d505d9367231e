"""B6b's share of its roofline in the traced step: its calls' frozen bound
(``costs/kernels.py:b6b``, causal, at the microbatch's shape, one call a
layer and microbatch) over the device time of its kernels."""
from perfbench.costs import kernels
from perfbench.readers import bound, missing, share_pct

# B6b's kernels, by the names of their CUDA functions (bf16 on wgmma, float32)
B6B = ("fa_bwd_dq_wgmma_kernel", "fa_bwd_dkdv_wgmma_kernel",
       "fa_bwd_dq_kernel", "fa_bwd_dkdv_kernel")


def read(r):
    tr, m, info = r["trace"], r["cell"].model, r["info"]
    t = tr.time_s(B6B)
    if not t:
        missing("b6b_roofline", B6B)
        return None
    per = bound(kernels.b6b(info["rows"], m["n_heads"], m["n_kv_heads"],
                            r["cell"].traffic["seq"], m["head_dim"]))
    calls = m["n_layers"] * info["microbatches"] * info["steps"]
    return share_pct(calls * per, t)
