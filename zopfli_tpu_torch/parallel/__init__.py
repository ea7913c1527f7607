"""Data-parallel block pipeline over local devices (dist) and master
blocks sharded over processes (multihost)."""
