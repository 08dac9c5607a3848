"""The LM stack of the port (``repro/models``): the dense, moe, ssm (RWKV6)
and hybrid (Mamba2 with a shared attention block) families behind
retrieval-augmented generation."""
