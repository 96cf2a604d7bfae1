"""Multi-device search and data-parallel encode (``clipx/parallel``)."""
