"""qwen3-8b's plain reference (hf:Qwen/Qwen3-8B): the dense family of
`perfbench.refs.common`, with qk-norm and RoPE at theta 1e6, in float32.
As published: no attention bias terms; the embedding and the head are
separate matrices (Qwen3-8B does not tie them)."""
from perfbench.refs.common import Arith, gaps, hidden, logits, train

__all__ = ["Arith", "gaps", "hidden", "logits", "train"]
