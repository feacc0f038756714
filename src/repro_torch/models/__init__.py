"""Language models of the attention family: layers, the layer stack and
the serving steps (prefill, cached decode)."""
