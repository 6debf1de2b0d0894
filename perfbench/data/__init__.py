"""Seeded generators of points and queries, one file each (``spec``)."""
