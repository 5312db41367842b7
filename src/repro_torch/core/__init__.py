"""Approximate-hardware core: backends, registry and the ``dense`` primitive."""
