"""Training on the port: AdamW (``optim``), the synthetic LM data (``data``),
the loss and train step (``trainer``) and checkpoints in the TD2 ``rsm``
format (``checkpoint``)."""
