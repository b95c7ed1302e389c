"""attn_roofline.train_dp4: `attn_roofline.train` of the four-card cell, which moves its own end-to-end
rate (`train_tokens_per_s.dp4`): the same reading of the same record."""
from harness import spec

read = spec.reader("attn_roofline.train")
