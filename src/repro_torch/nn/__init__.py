"""Model substrate of the port: configuration, parameter templates, and
the dense-attention and RWKV6 layers."""
