"""Launch: the training and serving drivers (port of ``repro/launch``;
``train.py`` and ``serve.py`` so far)."""
