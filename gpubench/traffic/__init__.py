"""Traffic mixes: read sets made from a seed by one generator
(``generate.py``) from the parameters in ``<traffic>.json``."""
