"""Language models: layers, the layer stack (attention family, RWKV6,
Mamba2), the serving steps (prefill, cached decode) and the training step
(loss, gradients, AdamW)."""
