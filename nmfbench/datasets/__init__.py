"""Count generators, one module a ``data.kind`` of the configurations."""
