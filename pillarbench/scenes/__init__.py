"""Scene kinds: each ``<scene>.py`` gives ``make(traffic, cfg, rng)``, the
pool of a run from the traffic file's parameters (see ``inputs.py``)."""
