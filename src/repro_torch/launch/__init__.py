"""repro_torch.launch — the KG serving driver (``serve``): the paper's
experiments 1 and 2 and the streaming demo; and the LM trainer
(``train``). Both run on the card by default."""
