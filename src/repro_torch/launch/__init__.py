"""repro_torch.launch — the KG serving driver (``serve``): the paper's
experiments 1 and 2 and the streaming demo, on the card by default."""
