"""optim substrate: AdamW and the LR schedules (port of ``repro/optim``)."""
