"""checkpoint substrate (port of ``repro/checkpoint``)."""
