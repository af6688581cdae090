"""train substrate: the training step (port of ``repro/train``)."""
