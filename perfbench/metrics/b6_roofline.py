"""B6's share of its roofline over the traced requests: the frozen bound
of its calls (``costs/kernels.py:b6``, causal, at each prompt's length,
one call a layer over each batch of prompts) over the device time of its
kernels."""
from perfbench.readers import b6_bound, missing, share_pct

# B6's kernels, by the names of their CUDA functions (bf16 on wgmma, float32)
B6 = ("flash_attention_wgmma_kernel", "flash_attention_kernel")


def read(r):
    tr, m = r["trace"], r["cell"].model
    t = tr.time_s(B6)
    if not t:
        missing("b6_roofline", B6)
        return None
    bound = sum(m["n_layers"] * b6_bound(m, 1, n) for n in r["info"]["lengths"])
    return share_pct(bound, t)
