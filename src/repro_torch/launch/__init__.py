"""Launch: the training driver (port of ``repro/launch``; ``train.py`` so far)."""
