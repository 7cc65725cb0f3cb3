"""The LM serving path of the reference's model sidecar (``repro/models``),
ported: dense GQA transformers and RWKV6, forward only."""
