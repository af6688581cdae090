"""data substrate: the seeded synthetic streams (port of ``repro/data``)."""
